"""The port's HRF data pipeline against the JAX package's, on the CPU.

No JAX compile: the modules held here (``data/``, ``ops/resize.py``,
``eval/noise.py``, the configs' transform pipelines) are numpy and scipy
on both sides.  Every comparison is exact (bit-equal arrays, equal dtypes,
equal generator states afterwards), except where a test says otherwise.

* The port's PNG codec (``data/imageio_utils.py``) against imageio, both
  ways: the port's encoder, read by imageio; PNGs of every supported mode
  (grey, grey + alpha, RGB, RGBA; 8 and 16 bits) written row filter by
  row filter by an independent byte-wise encoder here, and by imageio,
  read by the port.
* Each transform class, the val and train ``Compose`` of each HRF config,
  ``make_synthetic_hrf``, ``HRF_SPEC_Dataset`` records (SLO, FAF with its
  uint8 wrap, both mask variants, ``crop="oct"``), the loader (eval, and
  shuffled with per-position generators over two epochs with
  ``patches_from_single_image=2``), ``resize`` and the noise classes.
"""

import filecmp
import json
import os
import struct
import zlib

import imageio.v2 as iio
import numpy as np
import pytest

from multimodal_fusion_fpn_tpu.config import make_config as jmake_config
from multimodal_fusion_fpn_tpu.data import transforms as JT
from multimodal_fusion_fpn_tpu.data.hrf import HRF_SPEC_Dataset as JHRF
from multimodal_fusion_fpn_tpu.data.loader import DataLoader as JLoader
from multimodal_fusion_fpn_tpu.data.synthetic import \
    make_synthetic_hrf as jmake_synthetic_hrf
from multimodal_fusion_fpn_tpu.eval.configs import opt_factory as jopts
from multimodal_fusion_fpn_tpu.eval.noise import noise_classes as jnoise
from multimodal_fusion_fpn_tpu.ops.resize import resize as jresize

from multimodal_fusion_fpn_torch.config import make_config
from multimodal_fusion_fpn_torch.data import imageio_utils as tio
from multimodal_fusion_fpn_torch.data import transforms as TT
from multimodal_fusion_fpn_torch.data.hrf import HRF_SPEC_Dataset as THRF
from multimodal_fusion_fpn_torch.data.loader import DataLoader as TLoader
from multimodal_fusion_fpn_torch.data.synthetic import make_synthetic_hrf
from multimodal_fusion_fpn_torch.eval.configs import opt_factory as topts
from multimodal_fusion_fpn_torch.eval.noise import noise_classes as tnoise
from multimodal_fusion_fpn_torch.ops.resize import resize

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# colour type -> channels
MODES = {0: 1, 4: 2, 2: 3, 6: 4}
HRF_OPTS = ("hrf", "hrf_fusion", "hrf_fusion_comp_only")


def assert_same(a, b):
    """Equal structure, dtypes and bits (NaN where NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


# --- the PNG codec -------------------------------------------------------

def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows, kind, bpp):
    """Filter the byte rows (H, stride) with one PNG filter type, byte by
    byte as the PNG specification writes it."""
    out = []
    prior = [0] * rows.shape[1]
    for r in rows.tolist():
        f = []
        for i, x in enumerate(r):
            a = r[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            f.append((x - pred) & 0xFF)
        out.append(bytes([kind] + f))
        prior = r
    return b"".join(out)


def _write_png(path, arr, colour, depth, kind, interlace=0):
    h, w = arr.shape[:2]
    raw = (arr.astype(">u2") if depth == 16 else arr).reshape(h, -1)
    rows = np.frombuffer(raw.tobytes(), np.uint8).reshape(h, -1)
    bpp = MODES.get(colour, 1) * depth // 8
    data = (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                              colour, 0, 0, interlace))
            + _png_chunk(b"IDAT", zlib.compress(_filter_rows(rows, kind,
                                                             bpp)))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _image(rng, colour, depth, h=6, w=9):
    c = MODES[colour]
    shape = (h, w) if c == 1 else (h, w, c)
    return rng.integers(0, 2 ** depth, size=shape).astype(
        np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("colour", sorted(MODES))
def test_png_read_matches_imageio_every_mode_and_filter(tmp_path, colour,
                                                        depth):
    rng = np.random.default_rng(colour * 100 + depth)
    for kind in range(5):
        path = str(tmp_path / f"f{kind}.png")
        _write_png(path, _image(rng, colour, depth), colour, depth, kind)
        assert_same(tio.imread(path), np.asarray(iio.imread(path)))


def test_png_read_matches_imageio_on_its_own_files(tmp_path):
    rng = np.random.default_rng(1)
    for shape in ((31, 17), (5, 40, 3), (12, 7, 4), (1, 1), (64, 3)):
        a = rng.integers(0, 256, size=shape).astype(np.uint8)
        path = str(tmp_path / "w.png")
        iio.imwrite(path, a)
        assert_same(tio.imread(path), a)


def test_png_write_is_read_back_by_imageio(tmp_path):
    rng = np.random.default_rng(2)
    for shape in ((13, 29), (7, 11, 3), (9, 5, 4), (1, 1)):
        a = rng.integers(0, 256, size=shape).astype(np.uint8)
        path = str(tmp_path / "p.png")
        tio.imsave(path, a)
        assert_same(np.asarray(iio.imread(path)), a)
        assert_same(tio.imread(path), a)


def test_png_refuses_what_it_does_not_read_or_write(tmp_path):
    a = np.zeros((4, 4), np.uint8)
    path = str(tmp_path / "i.png")
    _write_png(path, a, 0, 8, 0, interlace=1)
    with pytest.raises(ValueError, match="interlace 1"):
        tio.imread(path)
    _write_png(path, a, 3, 8, 0)   # palette
    with pytest.raises(ValueError, match="colour type 3"):
        tio.imread(path)
    with pytest.raises(ValueError):
        tio.imsave(path, a.astype(np.float32))
    with pytest.raises(ValueError):
        tio.imsave(path, np.zeros((4, 4, 2), np.uint8))


# --- transforms and resize -----------------------------------------------

def _record(seed=0, d=12, h=20, w=24, eh=40):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(1, d, h, w)),
            "mask": (rng.random((1, d, 1, w)) > 0.5).astype(np.float64),
            "slo": rng.random((1, eh, 1, w)),
            "spacing": np.array([0.12, 0.004, 0.012])}


def _both(make):
    return make(JT), make(TT)


TRANSFORMS = {
    "rel_crop": lambda T: T.NewRandomRelCrop(
        reference_key="image", transform_keys=["image", "mask", "slo"],
        size=[None, 8, None, 16]),
    "rel_crop_oversize": lambda T: T.NewRandomRelCrop(
        reference_key="image", transform_keys=["image", "mask"],
        size=[None, 32, 10, 128]),
    "rel_fit": lambda T: T.NewRandomRelFit(
        transform_keys=["image", "mask", "slo"], fit=[None, 16, None, 16]),
    "rel_size": lambda T: T.NewRandomRelSize(
        transform_keys=["image", "mask", "slo"],
        fixed_size=[None, 7, None, 30]),
    "rotation180": lambda T: T.RandomRotation180(keys=["image", "mask"]),
    "disable": lambda T: T.Disable(keys=["image"]),
    "enface_rotation": lambda T: T.RandomEnfaceRotation(
        keys=["image", "mask", "slo"], range=(-90, 90), probablity=0.9),
    "downsample": lambda T: T.RandomDownsample(
        transform_keys=["image", "mask"], factor=2, dimensions=[1, 3]),
    "downsample_fixed": lambda T: T.RandomDownsample(
        transform_keys=["image"], factor=3, dimensions=[2],
        start_slice=1),
    "mirror": lambda T: T.RandomMirror(
        transform_keys=["image", "mask", "slo"], dimensions=[1, 3]),
    "zscore": lambda T: T.ZScoreNormalization(transform_keys=["image"],
                                              axis=(2, 3)),
    "zscore_dict": lambda T: T.ZScoreNormalization(
        transform_keys=["pair"], axis=(1, 3)),
    "intensity_shift": lambda T: T.IntensityShift(
        transform_keys=["image", "slo"], min=-0.2, max=0.2),
    "contrast": lambda T: T.ContrastAugmentation(
        transform_keys=["image", "pair"], min=0.9, max=1.1),
    "add_noise": lambda T: T.AddNoiseAugmentation(
        transform_keys=["image", "pair"], dim=(0,), sigma=0.2),
    "mul_noise": lambda T: T.MulNoiseAugmentation(
        transform_keys=["image"], dim=(1,), mu=1.0, sigma=0.05),
    "to_tensor": lambda T: T.ToTensorDict(
        transform_keys=["image", "mask", "pair", "absent"]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    """Each class on the same record with generators of the same seed:
    the same arrays, and the generators in the same state afterwards (the
    same draws in the same order).  Several seeds, so that the random
    branches go both ways."""
    jt, tt = _both(TRANSFORMS[name])
    for seed in range(6):
        rec = _record(seed)
        rec["pair"] = {0: rec["slo"].copy(), 1: rec["slo"][..., ::-1].copy(),
                       2: None}
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        got = tt(TT.deepcopy_record(rec), tr)
        want = jt(JT.deepcopy_record(rec), jr)
        assert_same(got, want)
        assert tr.bit_generator.state == jr.bit_generator.state


def _opt_pair(name, **kw):
    kw = dict(dict(training_dataset=name, model="FPNHybridFusion",
                   crop="relative_2d_max", fusion_modality="slo"), **kw)
    return (jopts[name](jmake_config(**kw)), topts[name](make_config(**kw)))


@pytest.mark.parametrize("crop", ["relative_2d_max", "oct"])
@pytest.mark.parametrize("name", HRF_OPTS)
def test_config_pipelines_match_jax(name, crop):
    """The val ``Compose`` of each HRF opt (no draws), and its train
    ``Compose`` with a seeded generator, on the same record."""
    jopt, topt = _opt_pair(name, crop=crop, rotation_augmentation=True)
    assert [type(t).__name__ for t in topt.get_val_transforms().transforms] \
        == [type(t).__name__ for t in jopt.get_val_transforms().transforms]
    rec = _record(3)
    assert_same(topt.get_val_transforms()(TT.deepcopy_record(rec)),
                jopt.get_val_transforms()(JT.deepcopy_record(rec)))
    for seed in range(3):
        got = topt.get_transforms()[0](TT.deepcopy_record(rec),
                                       np.random.default_rng(seed))
        want = jopt.get_transforms()[0](JT.deepcopy_record(rec),
                                        np.random.default_rng(seed))
        assert_same(got, want)


@pytest.mark.parametrize("case", [
    ((1, 16, 40, 32), (1, 16, 1, 32), 1),   # RelFit, upsampling one axis
    ((1, 13, 20, 31), (1, 32, 20, 128), 1),
    ((1, 80, 1, 32), (1, 320, 1, 128), 1),
    ((1, 30, 1, 50), (1, 16, 1, 48), 0),    # order 0 with anti-aliasing
    ((9, 17), (256, 512), 1)])
def test_resize_matches_jax(case):
    shape, out, order = case
    x = np.random.default_rng(4).normal(size=shape)
    assert_same(resize(x, out, order=order), jresize(x, out, order=order))
    b = x > 0
    assert_same(resize(b, out, order=0), jresize(b, out, order=0))
    assert_same(resize(x, out, order=1, anti_aliasing=False),
                jresize(x, out, order=1, anti_aliasing=False))


@pytest.mark.parametrize("kind", ["gaussian", "masking"])
def test_noise_matches_jax(kind):
    rng = np.random.default_rng(5)
    for shape in ((2, 1, 16, 10, 32), (1, 1, 40, 1, 24)):
        x = rng.normal(size=shape).astype(np.float32)
        got = tnoise[kind](0.2, seed=7)
        want = jnoise[kind](0.2, seed=7)
        for _ in range(2):   # the generator carries over between batches
            assert_same(got(x), want(x))


# --- the synthetic tree, the dataset and the loader ----------------------

SYNTH = dict(n_patients=4, visits_per_patient=2, d=16, h=24, w=32,
             enface_h=80, enface_w=32, seed=1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    tp = make_synthetic_hrf(str(root / "torch"), **SYNTH)
    jp = jmake_synthetic_hrf(str(root / "jax"), **SYNTH)
    return tp, jp


def test_synthetic_hrf_matches_jax(trees):
    """The same files; ``.npy`` and ``.json`` byte for byte, PNGs pixel for
    pixel (their bytes differ: another encoder)."""
    tp, jp = trees
    assert tp == {k: v.replace(os.sep + "jax", os.sep + "torch")
                  for k, v in jp.items()}
    troot, jroot = tp["oct"], jp["oct"]
    files = []
    for d, _, names in os.walk(jroot):
        files += [os.path.relpath(os.path.join(d, n), jroot) for n in names]
    tfiles = []
    for d, _, names in os.walk(troot):
        tfiles += [os.path.relpath(os.path.join(d, n), troot) for n in names]
    assert sorted(files) == sorted(tfiles) and len(files) == 8 * 8 + 2
    for rel in files:
        a, b = os.path.join(troot, rel), os.path.join(jroot, rel)
        if rel.endswith(".png"):
            assert_same(tio.imread(a), np.asarray(iio.imread(b)))
            assert_same(np.asarray(iio.imread(a)), np.asarray(iio.imread(b)))
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


def _datasets(paths, **kw):
    with open(paths["split"]) as f:
        split = json.load(f)
    ids = kw.pop("ids", split["train"] + split["test"])
    common = dict(patients=ids, visits_fn=paths["visits"], get_spacing=True)
    common.update(kw)
    return common


@pytest.mark.parametrize("kw", [
    dict(fusion_modality="slo", mask_variant="faf"),
    dict(fusion_modality="faf", mask_variant="oct"),
    dict(fusion_modality="slo", mask_variant="oct", crop="oct"),
    dict(fusion_modality="faf", mask_variant="faf", crop="oct",
         ids={"ids": ["P001V1", "P003V0"]})])
def test_hrf_records_match_jax(trees, kw):
    """``load_record`` of every visit, and ``__getitem__`` through the val
    transforms.  FAF is inverted on the uint8 array: 1 - 0 wraps to 1 and
    1 - x to 257 - x mod 256, which the port must copy."""
    tp, jp = trees
    tset = THRF(tp["oct"], **_datasets(tp, **kw))
    jset = JHRF(jp["oct"], **_datasets(jp, **kw))
    assert len(tset) == len(jset) > 0
    modality = kw["fusion_modality"]
    for i in range(len(jset)):
        got, want = tset.load_record(i), jset.load_record(i)
        for k in ("path", "slo_path"):   # the roots differ
            assert got.pop(k).replace(tp["oct"], "") == \
                want.pop(k).replace(jp["oct"], "")
        assert_same(got, want)
        if modality == "faf":
            raw = tio.imread(os.path.join(
                tp["oct"], got["FileSetId"],
                ("preprocessed_images/bscan_size." if kw.get("crop") == "oct"
                 else "") + f"faf.{got['FileSetId']}.png"))
            assert_same(got["faf"][0, :, 0, :],
                        (1 - raw).astype(np.uint8) / 256)
    opt = topts["hrf_fusion"](make_config(
        training_dataset="hrf_fusion", model="FPNHybridFusion",
        fusion_modality=modality))
    tset.transforms = opt.get_val_transforms()
    jset.transforms = _opt_pair("hrf_fusion",
                                fusion_modality=modality)[0] \
        .get_val_transforms()
    for i in range(len(jset)):
        got, want = tset[i], jset[i]
        for k in ("path", "slo_path"):
            got.pop(k), want.pop(k)
        assert_same(got, want)


def test_loader_matches_jax(trees):
    """The eval loader (``transform_rng=False``, one image per batch, split
    order) and a shuffled train loader (two epochs, per-position
    generators, ``patches_from_single_image=2``, three threads, batches of
    three with the last one short): the same batches, bit for bit."""
    tp, jp = trees
    jopt, topt = _opt_pair("hrf_fusion")
    tset = THRF(tp["oct"], transforms=topt.get_val_transforms(),
                **_datasets(tp, fusion_modality="slo"))
    jset = JHRF(jp["oct"], transforms=jopt.get_val_transforms(),
                **_datasets(jp, fusion_modality="slo"))
    runs = [(TLoader(tset, batch_size=1, num_workers=2, transform_rng=False),
             JLoader(jset, batch_size=1, num_workers=2, transform_rng=False))]
    kw = dict(multiplier=2, patches_from_single_image=2,
              fusion_modality="slo")
    tset = THRF(tp["oct"], transforms=topt.get_transforms()[0],
                **_datasets(tp, **kw))
    jset = JHRF(jp["oct"], transforms=jopt.get_transforms()[0],
                **_datasets(jp, **kw))
    runs.append((TLoader(tset, batch_size=3, shuffle=True, num_workers=3,
                         seed=11),
                 JLoader(jset, batch_size=3, shuffle=True, num_workers=3,
                         seed=11)))
    for tl, jl in runs:
        assert len(tl) == len(jl)
        for epoch in (0, 1):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            n = 0
            for got, want in zip(tl, jl):
                for k in ("path", "slo_path"):
                    got.pop(k), want.pop(k)
                assert_same(got, want)
                n += 1
            assert n == len(jl)
