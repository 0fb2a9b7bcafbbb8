"""The port's VRC slice against the JAX package's, on the CPU, with no JAX
compile: both sides are numpy (the JAX package's metrics call
scikit-learn, which the port does without).

* The global pixel metrics (``metrics/global_metrics.py``: AUROC, AUPR,
  AP, F1, Sens, Spec, Acc) against the JAX package's scikit-learn calls on
  seeded inputs (tied quantised scores and continuous ones, boolean and
  float64 ``gt``, 1 and 10^5 pixels): AUROC, AUPR and AP within 1e-12
  relative, the threshold metrics exact; and on each degenerate input
  (one class, no positive pixel, one label in the confusion matrix, 0 / 0,
  a continuous or multiclass ``gt``, a score that is not finite) the same
  value, NaN included, or the same exception type.
* The per-image ``IoU``, ``MSE``, ``L2``, ``L1`` and ``WeightedL1`` against
  JAX's on seeded batches, both masks empty and one-pixel images included.
* ``make_synthetic_vrc``: the same files, ``.npy`` and ``.json`` byte for
  byte, PNGs pixel for pixel (another encoder).
* ``VRC_Dataset`` records, bit for bit: the flat variant (full and lr2
  B-scans) with each mask variant, with and without ``crop="oct"``, and
  the crop variant (its ``cropped/`` files written here).
* The four VRC configs' val and train pipelines on the same records and
  seeds, the MRO of ``vrc_lr2_comp_only``, and both VRC opts' metric sets.
"""

import ast
import filecmp
import json
import os
import shutil
import warnings

import imageio.v2 as iio
import numpy as np
import pytest

from multimodal_fusion_fpn_tpu.config import make_config as jmake_config
from multimodal_fusion_fpn_tpu.data.synthetic import \
    make_synthetic_vrc as jmake_synthetic_vrc
from multimodal_fusion_fpn_tpu.data.vrc import VRC_Dataset as JVRC
from multimodal_fusion_fpn_tpu.eval.configs import opt_factory as jopts
from multimodal_fusion_fpn_tpu.metrics import global_metrics as JG
from multimodal_fusion_fpn_tpu.metrics import streaming as JM
from multimodal_fusion_fpn_tpu.train.configs import \
    data_config_factory as jconfigs

import multimodal_fusion_fpn_torch
from multimodal_fusion_fpn_torch.config import make_config
from multimodal_fusion_fpn_torch.data import imageio_utils as tio
from multimodal_fusion_fpn_torch.data.synthetic import make_synthetic_vrc
from multimodal_fusion_fpn_torch.data.vrc import VRC_Dataset as TVRC
from multimodal_fusion_fpn_torch.eval.configs import opt_factory as topts
from multimodal_fusion_fpn_torch.metrics import global_metrics as TG
from multimodal_fusion_fpn_torch.metrics import streaming as TM
from multimodal_fusion_fpn_torch.train.configs import \
    data_config_factory as tconfigs

from test_torch_data import assert_same
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GLOBAL = ("AUROC", "AUPR", "AP", "F1", "Sens", "Spec", "Acc")
CURVES = ("AUROC", "AUPR", "AP")
VRC_CONFIGS = ("vrc", "vrc_crop", "vrc_lr2", "vrc_lr2_comp_only")
VRC_OPTS = ("vrc", "vrc_lr2_comp_only")


# --- the global pixel metrics ---------------------------------------------

def _seeded(n, seed, tied, boolean, p_pos=0.3):
    rng = np.random.default_rng(seed)
    gt = rng.random(n) < p_pos
    score = np.clip(0.3 * gt + rng.random(n) * 0.7, 0, 1)
    if tied:   # 17 levels: long runs of equal scores
        score = np.round(score * 16) / 16
    return (gt if boolean else gt.astype(np.float64)), score


SEEDED = {f"{n}px_{'tied' if t else 'cont'}_{'bool' if b else 'f64'}":
          (n, t, b) for n in (1, 100, 10 ** 5) for t in (False, True)
          for b in (False, True)}
DEGENERATE = {
    "no_positive": (np.zeros(50), np.linspace(0, 1, 50)),
    "no_negative": (np.ones(50), np.linspace(0, 1, 50)),
    "no_positive_bool": (np.zeros(9, bool), np.linspace(0, 1, 9)),
    "one_label_low": (np.zeros(7), np.full(7, 0.2)),
    "one_label_high": (np.ones(7), np.full(7, 0.7)),
    "zero_over_zero": (np.zeros(7), np.full(7, 0.7)),
    "one_pixel_positive": (np.ones(1), np.full(1, 0.3)),
    "continuous_gt": (np.array([0.0, 0.5, 1.0, 1.0]),
                      np.array([0.1, 0.6, 0.8, 0.3])),
    "multiclass_gt": (np.array([0.0, 1.0, 2.0, 1.0]),
                      np.array([0.1, 0.6, 0.8, 0.3])),
    "zero_two_gt": (np.array([0.0, 2.0, 2.0, 0.0]),
                    np.array([0.1, 0.2, 0.9, 0.3])),
    "minus_one_one_gt": (np.array([-1.0, 1.0, 1.0]),
                         np.array([0.1, 0.2, 0.9])),
    "nan_score": (np.array([0.0, 1.0, 1.0]), np.array([np.nan, 0.3, 0.6])),
    "nan_gt": (np.array([0.0, np.nan, 1.0]), np.array([0.2, 0.3, 0.6])),
    "all_tied": (np.array([0.0, 1.0, 1.0, 0.0]), np.full(4, 0.5)),
}


def _outcome(metric, gt, pred):
    """(value or None, exception type or None) of ``metric``."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with np.errstate(all="ignore"):
                return metric.calculate(gt, pred), None
    except Exception as exc:   # noqa: BLE001 (the type is what is held)
        return None, type(exc)


def _assert_same_outcome(name, gt, pred):
    got, got_exc = _outcome(getattr(TG, name)(), gt, pred)
    want, want_exc = _outcome(getattr(JG, name)(), gt, pred)
    assert got_exc is want_exc, (name, got, got_exc, want, want_exc)
    if want_exc is not None:
        return
    assert type(got) is type(want) or np.isnan(want), (name, got, want)
    if np.isnan(want):
        assert np.isnan(got), (name, got)
    elif name in CURVES:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=name)
    else:
        assert got == want, (name, got, want)


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_global_metrics_match_sklearn(case):
    n, tied, boolean = SEEDED[case]
    gt, pred = _seeded(n, n + 7 * tied, tied, boolean)
    if n == 1:
        gt[0] = True
    for name in GLOBAL:
        _assert_same_outcome(name, gt, pred)


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_global_metrics_degenerate_match_sklearn(case):
    gt, pred = DEGENERATE[case]
    for name in GLOBAL:
        _assert_same_outcome(name, gt, pred)


def test_global_metric_outcomes_of_note():
    """What the degenerate cases give (scikit-learn 1.9.0): AUROC NaN with
    one class, AUPR 0.5 and AP 0 with no positive pixel, F1 0 at 0 / 0,
    Sens NaN (int64 0 / 0), ValueError for a one-label confusion matrix
    and for continuous targets."""
    zeros, scores = DEGENERATE["no_positive"]
    assert np.isnan(TG.AUROC().calculate(zeros, scores))
    assert TG.AUPR().calculate(zeros, scores) == 0.5
    assert TG.AP().calculate(zeros, scores) == 0.0
    assert TG.F1().calculate(*DEGENERATE["one_label_low"]) == 0.0
    with np.errstate(invalid="ignore"):
        assert np.isnan(TG.Sens().calculate(*DEGENERATE["zero_over_zero"]))
    for name in ("Sens", "Spec", "Acc"):
        with pytest.raises(ValueError):
            getattr(TG, name)().calculate(*DEGENERATE["one_label_low"])
    for name in GLOBAL:
        with pytest.raises(ValueError):
            getattr(TG, name)().calculate(*DEGENERATE["continuous_gt"])


# --- the per-image metrics ---------------------------------------------------

def _batches():
    rng = np.random.default_rng(13)
    out = []
    for shape in ((3, 1, 12, 1, 20), (1, 1, 9, 1, 7), (2, 1, 1, 1, 1),
                  (4, 1, 1, 1, 1)):
        p = rng.random(shape)
        g = (rng.random(shape) > 0.6).astype(np.float64)
        w = np.where(rng.random(shape) > 0.5, rng.random(shape), 0.0)
        out.append({"p": p, "g": g, "w": w})
    # both masks empty, and one of them
    z = np.zeros((2, 1, 8, 1, 8))
    out.append({"p": z + 0.1, "g": z.copy(), "w": z + 1.0})
    out.append({"p": z + 0.9, "g": z.copy(), "w": z + 1.0})
    return out


@pytest.mark.parametrize("name", ["IoU", "MSE", "L2", "L1", "WeightedL1",
                                  "WeightedL1_unmasked"])
def test_streaming_metrics_match_jax(name):
    kw = {"mask": False} if name.endswith("unmasked") else {}
    cls = name.split("_")[0]
    got = getattr(TM, cls)("prediction", "mask", **kw)
    want = getattr(JM, cls)("prediction", "mask", **kw)
    for b in _batches():
        ground = {"mask": b["g"], "weight": b["w"]}
        predict = {"prediction": b["p"]}
        for m in (got, want):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m.update(ground, predict)
    assert len(got.accumulator) == len(want.accumulator) > 0
    np.testing.assert_array_equal(got.accumulator, want.accumulator)
    assert got.get() == want.get()
    if cls == "IoU":   # both masks empty: 0, where Dice gives 1
        assert got.accumulator[-2] == 0.0


# --- the synthetic tree, the dataset and the configs --------------------

SYNTH = dict(n_patients=4, visits_per_patient=2, d=16, h=24, w=32,
             enface_h=80, enface_w=32, seed=2)


def _crop_variant(root, rng):
    """The ``cropped/`` files of the crop variant, which the synthetic
    writer leaves out: a volume, a mask PNG and an SLO PNG per visit."""
    with open(os.path.join(root, "vrc_data.json")) as f:
        visits = json.load(f)
    for pid, vs in visits.items():
        d = os.path.join(root, pid, "cropped")
        os.makedirs(d)
        for v in vs:
            fsid = v["FileSetId"]
            np.save(os.path.join(d, f"bscan_crop.{fsid}.npy"),
                    rng.normal(size=(16, 24, 32)).astype(np.float32))
            tio.imsave(os.path.join(d, f"vs_crop.{fsid}.png"),
                       rng.integers(0, 256, (16, 32)).astype(np.uint8))
            tio.imsave(os.path.join(d, f"slo_crop.{fsid}.png"),
                       rng.integers(0, 256, (16, 32)).astype(np.uint8))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_vrc")
    tp = make_synthetic_vrc(str(root / "torch"), **SYNTH)
    jp = jmake_synthetic_vrc(str(root / "jax"), **SYNTH)
    files = _files(jp["oct"])
    _crop_variant(tp["oct"], np.random.default_rng(5))
    for pid in sorted(os.listdir(tp["oct"])):
        if os.path.isdir(os.path.join(tp["oct"], pid, "cropped")):
            shutil.copytree(os.path.join(tp["oct"], pid, "cropped"),
                            os.path.join(jp["oct"], pid, "cropped"))
    return tp, jp, files


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def test_synthetic_vrc_matches_jax(tmp_path):
    """The same files; ``.npy`` and ``.json`` byte for byte, PNGs pixel for
    pixel (their bytes differ: another encoder)."""
    tp = make_synthetic_vrc(str(tmp_path / "torch"), **SYNTH)
    jp = jmake_synthetic_vrc(str(tmp_path / "jax"), **SYNTH)
    assert tp == {k: v.replace(os.sep + "jax", os.sep + "torch")
                  for k, v in jp.items()}
    files = _files(jp["oct"])
    assert files == _files(tp["oct"]) and len(files) == 8 * 7 + 2
    for rel in files:
        a, b = os.path.join(tp["oct"], rel), os.path.join(jp["oct"], rel)
        if rel.endswith(".png"):
            assert_same(tio.imread(a), np.asarray(iio.imread(b)))
            assert_same(np.asarray(iio.imread(a)), np.asarray(iio.imread(b)))
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


def _kw(paths, **kw):
    with open(paths["split"]) as f:
        split = json.load(f)
    return dict(dict(patients=split["train"] + split["test"],
                     visits_fn=paths["visits"], get_spacing=True), **kw)


@pytest.mark.parametrize("kw", [
    dict(mask_variant="faf"),
    dict(mask_variant="sq_proj_dil", crop="oct"),
    dict(mask_variant=None, preprocessed_bscan="lr2", crop="oct"),
    dict(mask_variant="sq_proj_dil", preprocessed_bscan="lr2"),
    dict(oct_variant="crop", get_spacing=False)])
def test_vrc_records_match_jax(trees, kw):
    """``load_record`` of every visit: the flat variant's boolean mask,
    the crop variant's float one, spacing read raw, the ``bscan_size.``
    SLO under ``crop="oct"``; a split of FileSetIds is refused."""
    tp, jp, _ = trees
    tset, jset = TVRC(tp["oct"], **_kw(tp, **kw)), JVRC(jp["oct"],
                                                        **_kw(jp, **kw))
    assert len(tset) == len(jset) == 6
    for i in range(len(jset)):
        got, want = tset.load_record(i), jset.load_record(i)
        assert got.pop("path").replace(tp["oct"], "") == \
            want.pop("path").replace(jp["oct"], "")
        assert_same(got, want)
    assert got["mask"].dtype == (bool if kw.get("oct_variant") != "crop"
                                 else np.float64)
    for cls, p in ((TVRC, tp), (JVRC, jp)):
        with pytest.raises(NotImplementedError):
            cls(p["oct"], **_kw(p, patients={"ids": ["V000S0"]}))


def _config_pair(name, opt=False, **kw):
    kw = dict(dict(training_dataset=name, model="FPNHybridFusion",
                   crop="relative_2d_max", fusion_modality="slo",
                   multiplier=2), **kw)
    tfac, jfac = (topts, jopts) if opt else (tconfigs, jconfigs)
    return tfac[name](make_config(**kw)), jfac[name](jmake_config(**kw))


@pytest.mark.parametrize("crop", ["relative_2d_max", "oct"])
@pytest.mark.parametrize("name", VRC_CONFIGS)
def test_vrc_config_pipelines_match_jax(trees, name, crop):
    """Each VRC config's val dataset through its val ``Compose`` (no
    draws), and its train dataset through its train ``Compose`` with
    seeded generators, on the same tree: the same records."""
    tp, jp, _ = trees
    if name == "vrc_crop":
        mask = "faf"
    else:
        mask = "sq_proj_dil" if crop == "oct" else "faf"
    tcfg, jcfg = _config_pair(name, crop=crop, mask_variant=mask)
    tcfg.paths, jcfg.paths = dict(tp), dict(jp)
    assert [type(t).__name__ for t in tcfg.get_val_transforms().transforms] \
        == [type(t).__name__ for t in jcfg.get_val_transforms().transforms]
    with open(tp["split"]) as f:
        ids = json.load(f)["test"]
    tval = tcfg.val_data(ids, tcfg.get_val_transforms())
    jval = jcfg.val_data(ids, jcfg.get_val_transforms())
    ttrain = tcfg.train_data(ids, tcfg.get_transforms()[0])
    jtrain = jcfg.train_data(ids, jcfg.get_transforms()[0])
    assert len(tval) == len(jval) and len(ttrain) == len(jtrain) == 4
    for i in range(len(jval)):
        got, want = tval[i], jval[i]
        got.pop("path"), want.pop("path")
        assert_same(got, want)
    for i in range(len(jtrain)):
        got = ttrain.get_example(i, np.random.default_rng(i))
        want = jtrain.get_example(i, np.random.default_rng(i))
        got.pop("path"), want.pop("path")
        assert_same(got, want)


def test_vrc_registries_and_mro_match_jax():
    """The four configs and two opts are registered; ``vrc_lr2_comp_only``
    keeps the JAX MRO (VRC's data, the comp-only transforms); each opt's
    per-image and global metric sets, Hausdorff's device flag included."""
    for name in VRC_CONFIGS:
        assert name in tconfigs and name in jconfigs
    names = lambda c: [k.__name__ for k in c.__mro__]  # noqa: E731
    for name in ("vrc_lr2_comp_only",):
        assert names(tconfigs[name]) == names(jconfigs[name])
    for name in VRC_OPTS:
        assert names(topts[name]) == names(jopts[name])
        topt, jopt = _config_pair(name, opt=True)
        assert list(topt.global_metrics) == list(jopt.global_metrics)
        assert [type(m).__name__ for m in topt.global_metrics.values()] \
            == [type(m).__name__ for m in jopt.global_metrics.values()]
        assert {k: (type(m).__name__, getattr(m, "device", None))
                for k, m in topt.metrics_val.items()} == {
            k: (type(m).__name__, getattr(m, "device", None))
            for k, m in jopt.metrics_val.items()}
    topt, jopt = _config_pair("vrc_lr2_comp_only", opt=True)
    assert [type(t).__name__ for t in topt.get_val_transforms().transforms] \
        == [type(t).__name__ for t in jopt.get_val_transforms().transforms]
    assert "Disable" in [type(t).__name__
                         for t in topt.get_val_transforms().transforms]
    assert list(topt.transformations) == list(jopt.transformations)
    assert list(topts) == list(jopts) and list(tconfigs) == list(jconfigs)


def test_vrc_modules_import_no_jax_nor_host_libraries():
    """The new modules, and the port modules they import, import none of
    jax, flax, scikit-learn, pandas, imageio, PIL or the JAX package."""
    root = os.path.dirname(multimodal_fusion_fpn_torch.__file__)
    todo = ["metrics.global_metrics", "metrics.streaming", "data.vrc",
            "data.synthetic", "train.configs", "eval.configs"]
    seen = set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = os.path.join(root, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(root, *mod.split("."), "__init__.py")
        if not os.path.exists(path):   # a name, not a module
            continue
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] + [f"{node.module}.{a.name}"
                                      for a in node.names]
                     if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "sklearn", "pandas", "imageio",
                    "PIL", "multimodal_fusion_fpn_tpu"), (mod, name)
                prefix = "multimodal_fusion_fpn_torch."
                if name.startswith(prefix):
                    todo.append(name[len(prefix):])
    assert len(seen) > 10
