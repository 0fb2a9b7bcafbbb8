"""Exact shape-bucketed ensemble serving of the port against the JAX
package, on the CPU.

Same numpy inputs through both, fp32.  Tolerances:

* the extent ops (``ops/dynamic_extent.py``) at the cases of
  ``tests/test_dynamic_extent.py``: bit-equal to JAX's twins;
* the plain version of K7 (``fused_conv_dyn_plain``) against JAX's
  ``fused_conv_dyn`` / ``fused_conv_strided_dyn``, through its XLA
  reference and through the Pallas body in interpret mode, with garbage
  beyond the extents: 1e-5;
* FPNHybridFusion on a zero-padded batch with its true extents against the
  JAX model on the same batch (``tiny_spec`` widths): 1e-4, and against its
  own run on the unpadded batch: 1e-5;
* the device Hausdorff distances against JAX's: 1e-5 (hd95 1e-4, the
  tolerance of ``tests/test_device_hausdorff.py``); an empty mask gives NaN;
* ``bucket_pad`` against ``_bucket_pad``: equal arrays; ``evaluate`` with
  bucket 64 and ``eval_batch`` 2 against bucket 0: the same rows in the
  same order, each value within 1e-5.

Each JAX model reference is computed once, in a module fixture.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu.config import make_config
from multimodal_fusion_fpn_tpu.eval.harness import _bucket_pad
from multimodal_fusion_fpn_tpu.eval.harness import \
    compute_metrics as jax_compute_metrics
from multimodal_fusion_fpn_tpu.metrics import streaming as jstreaming
from multimodal_fusion_fpn_tpu.metrics.device import \
    hausdorff_device as jax_hausdorff
from multimodal_fusion_fpn_tpu.models import blocks as jblocks
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.ops import dynamic_extent as jdyn
from multimodal_fusion_fpn_tpu.ops.pallas import fused_conv as jfc

from multimodal_fusion_fpn_torch.eval.ensemble import make_ensemble_eval_step
from multimodal_fusion_fpn_torch.eval.harness import (bucket_pad,
                                                      compute_metrics,
                                                      evaluate)
from multimodal_fusion_fpn_torch.metrics import streaming
from multimodal_fusion_fpn_torch.metrics.device import hausdorff_device
from multimodal_fusion_fpn_torch.metrics.hausdorff import hd as host_hd
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.ops import dynamic_extent as tdyn
from multimodal_fusion_fpn_torch.ops import fused_conv as tfc
from multimodal_fusion_fpn_torch.weights import state_dict_from_jax

from rollfree_calls import rollfree_calls  # noqa: F401 (fixture)
from test_torch_model import compile_ref, random_trees
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# --- the extent ops ---------------------------------------------------------


def _padded(x, pad_to):
    return np.pad(x, [(0, p - s) for s, p in zip(x.shape, pad_to)])


@pytest.mark.parametrize("n_true,m_true", [(37, 12), (24, 24), (16, 5),
                                           (40, 7)])
def test_adaptive_max_dynamic_matches_jax(n_true, m_true):
    rng = np.random.default_rng(0)
    xp = _padded(rng.normal(size=(2, n_true, 3)).astype(np.float32),
                 (2, 48, 3))
    ref = jdyn.adaptive_max_pool_dynamic(
        jnp.asarray(xp), (jnp.int32(n_true),), (jnp.int32(m_true),),
        axes=(1,), max_ratio=8)
    got = tdyn.adaptive_max_pool_dynamic(torch.from_numpy(xp), (n_true,),
                                         (m_true,), axes=(1,), max_ratio=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_true,m_true", [(37, 12), (16, 31), (9, 9)])
def test_linear_resize_dynamic_matches_jax(n_true, m_true):
    rng = np.random.default_rng(1)
    xp = _padded(rng.normal(size=(2, n_true, 3)).astype(np.float32),
                 (2, 40, 3))
    ref = jdyn.linear_resize_dynamic(
        jnp.asarray(xp), (jnp.int32(n_true),), (jnp.int32(m_true),),
        axes=(1,))
    got = tdyn.linear_resize_dynamic(torch.from_numpy(xp), (n_true,),
                                     (m_true,), axes=(1,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_in,scale", [(7, 2.0), (14, 1.5), (8, 2.5)])
def test_upsample_indices_dynamic_match_jax(n_in, scale):
    n_out = int(n_in * scale)
    ref = jdyn.upsample_nearest_indices_dynamic(jnp.int32(n_in),
                                                jnp.int32(n_out), n_out + 5)
    got = tdyn.upsample_nearest_indices_dynamic(n_in, n_out, n_out + 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mask_valid_and_masked_mean_match_jax():
    x = np.random.default_rng(2).normal(size=(2, 10, 4)).astype(np.float32)
    ref = jdyn.mask_valid(jnp.asarray(x), {1: jnp.int32(6), 2: None})
    got = tdyn.mask_valid(torch.from_numpy(x), {1: 6, 2: None})
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tdyn.masked_mean(got, 1, 6).numpy(),
        np.asarray(jdyn.masked_mean(ref, axis=1, n_true=jnp.int32(6))))


# --- K7's plain version against the JAX extents conv ------------------------

# kshape, z stride; the true extents (yt, xt, zt) inside (Y, X, Z) =
# (4, 6, 32), with garbage beyond them
DYN_CASES = [((1, 3, 3), 1), ((3, 1, 1), 1), ((1, 1, 3), 1), ((1, 1, 1), 1),
             ((1, 1, 3), 2)]
EXTENTS = (3, 5, 21)


def _dyn_case(kshape, sz):
    B, Y, X, Z, ci, co = 1, 4, 6, 32, 8, 16
    rng = np.random.default_rng(sum(kshape) + sz)
    x = rng.normal(size=(B, Y, X, Z, ci)).astype(np.float32)
    s = rng.normal(size=ci).astype(np.float32)
    b = rng.normal(size=ci).astype(np.float32)
    w = (rng.normal(size=kshape + (ci, co)) * 0.3).astype(np.float32)
    return x, s, b, w


def _jax_dyn(kshape, sz, impl, bs=8):
    """f(x, s, b, w): the JAX extents conv at the module's extents."""
    def f(x, s, b, w):
        X, Z = x.shape[2], x.shape[3]
        nb = Z // bs
        dyn = tuple(jnp.int32(e) for e in EXTENTS)
        args = ([jfc.pack(x, bs)], [jnp.tile(s, bs)], [jnp.tile(b, bs)], w,
                X, nb, bs)
        if sz == 1:
            return jfc.unpack(jfc.fused_conv_dyn(*args, dyn, relu=True,
                                                 impl=impl), X, nb, bs)
        y = jfc.fused_conv_strided_dyn(*args, valid_in=bs, dyn_extents=dyn,
                                       relu=True, impl=impl)
        return jfc.unpack_slots(y, X, nb, bs, bs // 2)
    return f


@pytest.fixture(scope="module")
def jax_dyn_convs(rollfree_calls):
    """The JAX extents conv for every case below, keyed (kshape, z stride,
    impl): traced one after another (the Pallas body in interpret mode;
    impl 'rollfree' the Pallas (1,3,3) one with MMF_ROLLFREE=1, counted by
    ``rollfree_calls``), compiled side by side in threads."""
    # the costliest compile first, so it overlaps the other traces
    jobs = [((1, 3, 3), 1, "rollfree")]
    jobs += [(k, sz, i) for k, sz in DYN_CASES for i in ("ref", "pallas")]
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for kshape, sz, impl in jobs:
            args = [jnp.asarray(a) for a in _dyn_case(kshape, sz)]
            key = (kshape, sz, impl)
            with rollfree_calls.trace(key, impl == "rollfree"):
                jfc.set_interpret_mode(impl != "ref")
                try:
                    lowered = jax.jit(_jax_dyn(
                        kshape, sz, "ref" if impl == "ref" else "pallas")
                    ).lower(*args)
                finally:
                    jfc.set_interpret_mode(False)
            pending[key] = (pool.submit(compile_ref, lowered), args)
        return {k: np.asarray(c.result()(*args))
                for k, (c, args) in pending.items()}


def _check_dyn_case(kshape, sz, ref):
    x, s, b, w = _dyn_case(kshape, sz)
    t = lambda a: torch.from_numpy(a)
    got = tfc.fused_conv_dyn_plain(t(x), t(s), t(b), t(w), True, sz, EXTENTS)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version on a CPU tensor
    torch.testing.assert_close(
        tfc.fused_conv(t(x), t(s), t(b), t(w), True, sz,
                       dyn_extents=EXTENTS), got, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("case", DYN_CASES,
                         ids=lambda c: "k" + "".join(map(str, c[0]))
                         + f"s{c[1]}")
def test_fused_conv_dyn_plain_matches_jax(case, impl, jax_dyn_convs):
    kshape, sz = case
    _check_dyn_case(kshape, sz, jax_dyn_convs[(kshape, sz, impl)])


def test_fused_conv_dyn_plain_matches_jax_rollfree_body(jax_dyn_convs,
                                                        rollfree_calls):
    """K9 with extents: K7's plain version against the roll-free forward
    body ``_rf_kernel`` (``with_dyn``, MMF_ROLLFREE=1) in interpret mode,
    which ran, on garbage beyond the extents; no other case ran it."""
    key = ((1, 3, 3), 1, "rollfree")
    assert rollfree_calls.by_case[key]["_rf_kernel"] > 0
    rollfree_calls.check()
    _check_dyn_case((1, 3, 3), 1, jax_dyn_convs[key])


def test_fused_conv_dyn_is_eval_only_and_checks_extents():
    x = torch.randn(1, 2, 3, 8, 8)
    w = torch.randn(1, 3, 3, 8, 16, requires_grad=True)
    with pytest.raises(ValueError, match="eval-only"):
        tfc.fused_conv(x, None, None, w, False, dyn_extents=(2, 3, 8))
    with pytest.raises(ValueError, match="eval-only"):
        tfc.fused_conv(x, None, None, w.detach(), False, with_stats=True,
                       dyn_extents=(2, 3, 8))
    for bad in ((3, 3, 8), (2, 0, 8), (2, 3)):
        with pytest.raises(ValueError, match="extents"):
            tfc.fused_conv(x, None, None, w.detach(), False,
                           dyn_extents=bad)


# --- the bucketed model -----------------------------------------------------

Y, Z, X, EH = 8, 64, 32, 80
PAD_IMAGE, PAD_SLO = {2: 16, 3: 96, 4: 48}, {2: 96, 4: 48}


def _pad_to(a, dims):
    pads = [(0, 0)] * a.ndim
    for d, tgt in dims.items():
        pads[d] = (0, tgt - a.shape[d])
    return np.pad(a, pads)


def _cfg(crop):
    return make_config(model="FPNHybridFusion", crop=crop,
                       fusion_modality="slo")


@pytest.fixture(scope="module")
def bucketed_case(tiny_spec):
    """The batch, its zero-padded twin with the true extents, numpy JAX
    trees at the tiny widths and the JAX predictions on the padded batch:
    '2d_max' in fused mode 'on', '2d' in mode 'off'."""
    rng = np.random.default_rng(5)
    batch = {"image": rng.normal(size=(1, 1, Y, Z, X)).astype(np.float32),
             "slo": rng.normal(size=(1, 1, EH, 1, X)).astype(np.float32)}
    padded = {"image": _pad_to(batch["image"], PAD_IMAGE),
              "slo": _pad_to(batch["slo"], PAD_SLO),
              "__valid_image__": np.asarray([Y, Z, X], np.int32),
              "__valid_enface__": np.asarray([EH, X], np.int32)}
    model = jbuild(_cfg("relative_2d_max"), spec=tiny_spec, remat=False)
    template = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False))
    params, stats = random_trees(template, seed=8)
    jb = {k: jnp.asarray(v) for k, v in padded.items()}
    compiled = {}
    # trace both modes in turn (the fused mode is a global of the JAX
    # package), compile them side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        prev = jblocks._FUSED_MODE
        try:
            for crop, mode in (("relative_2d_max", "on"),
                               ("relative_2d", "off")):
                jblocks.set_fused_stage_mode(mode)
                jm = jbuild(_cfg(crop), spec=tiny_spec, remat=False)
                lowered = jax.jit(lambda p, s, b, jm=jm: jm.apply(
                    {"params": p, "batch_stats": s}, b,
                    train=False)).lower(params, stats, jb)
                compiled[crop] = pool.submit(compile_ref, lowered)
        finally:
            jblocks.set_fused_stage_mode(prev)
        ref = {crop: np.asarray(c.result()(params, stats, jb)["prediction"])
               for crop, c in compiled.items()}
    return dict(batch=batch, padded=padded, spec=ArchSpec(tiny_spec.channels),
                sd=state_dict_from_jax(params, stats), ref=ref,
                template=template)


def _port(case, crop, batch, kernels=True):
    model = build_model(_cfg(crop), spec=case["spec"], device="cpu")
    model.load_state_dict(case["sd"], strict=True)
    with torch.no_grad():
        return model({k: torch.as_tensor(v) for k, v in batch.items()},
                     kernels=kernels)["prediction"].numpy()


@pytest.mark.parametrize("crop", ["relative_2d_max", "relative_2d"])
def test_bucketed_hybrid_fusion_matches_jax(bucketed_case, crop):
    """The padded batch with extents through both packages (JAX in fused
    mode 'on' for '2d_max', 'off' for '2d'), compared on the whole padded
    output."""
    got = _port(bucketed_case, crop, bucketed_case["padded"])
    ref = bucketed_case["ref"][crop]
    assert got.shape == ref.shape == (1, 1, 16, 1, 48)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("crop", ["relative_2d_max", "relative_2d"])
def test_bucketed_run_matches_unbucketed(bucketed_case, crop):
    """The port's bucketed prediction, cropped, against its own run on the
    unpadded batch; the kernel route and the plain route alike."""
    ref = _port(bucketed_case, crop, bucketed_case["batch"])
    for kernels in (True, False):
        got = _port(bucketed_case, crop, bucketed_case["padded"], kernels)
        np.testing.assert_allclose(got[:, :, :Y, :, :X], ref, rtol=1e-5,
                                   atol=1e-5)


def test_extents_of_the_padded_shape_are_not_bucketing(bucketed_case):
    """The control: extents that claim the padded shape change the
    prediction on the true region (the padding is read as data)."""
    bad = dict(bucketed_case["padded"])
    bad["__valid_image__"] = np.asarray([16, 96, 48], np.int32)
    bad["__valid_enface__"] = np.asarray([96, 48], np.int32)
    ref = _port(bucketed_case, "relative_2d_max", bucketed_case["batch"])
    got = _port(bucketed_case, "relative_2d_max", bad)[:, :, :Y, :, :X]
    assert np.abs(got - ref).max() > 1e-3


def test_bucketed_model_routes_every_fused_conv_to_the_extents_instance(
        bucketed_case, monkeypatch):
    """Every conv that takes the kernel unbucketed takes it with the true
    extents of its input under bucketing (the 2D stages as X = 1)."""
    from multimodal_fusion_fpn_torch.models import blocks as tblocks
    seen = []
    real = tblocks.fused_conv

    def spy(x, s, b, w, relu, stride_z=1, dyn_extents=None):
        seen.append((tuple(x.shape), dyn_extents))
        return real(x, s, b, w, relu, stride_z, dyn_extents=dyn_extents)

    monkeypatch.setattr(tblocks, "fused_conv", spy)
    _port(bucketed_case, "relative_2d_max", bucketed_case["batch"])
    n_plain = len(seen)
    assert n_plain and all(e is None for _, e in seen)
    seen.clear()
    _port(bucketed_case, "relative_2d_max", bucketed_case["padded"])
    assert len(seen) == n_plain
    for shape, ext in seen:
        assert ext is not None and all(
            1 <= e <= n for e, n in zip(ext, shape[1:4])), (shape, ext)
        assert ext != shape[1:4]
    # at these widths the first 3D conv that takes the kernel is in stage
    # 3, after two (1, 2, 2) pools
    first3d = next(e for s, e in seen if s[2] > 1)
    assert first3d == (Y, X // 4, Z // 4)


# --- Hausdorff distances ------------------------------------------------------

@pytest.mark.parametrize("connectivity", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_hausdorff_device_matches_jax(connectivity, seed):
    rng = np.random.default_rng(seed)
    H, W = int(rng.integers(8, 50)), int(rng.integers(8, 100))
    p = rng.random((H, W)) > 0.6
    g = rng.random((H, W)) > 0.55
    sp = np.array([0.12, 0.011])
    ref = jax_hausdorff(jnp.asarray(p), jnp.asarray(g), jnp.asarray(sp),
                        connectivity=connectivity)
    got = hausdorff_device(torch.from_numpy(p), torch.from_numpy(g), sp,
                           connectivity=connectivity)
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-4)
    np.testing.assert_allclose(
        float(got[0]), host_hd(p, g, voxelspacing=sp,
                               connectivity=connectivity), rtol=1e-5)


def test_hausdorff_device_empty_mask_is_nan():
    p = torch.zeros(16, 16, dtype=torch.bool)
    hd, hd95 = hausdorff_device(p, ~p, [1.0, 1.0])
    assert torch.isnan(hd) and torch.isnan(hd95)


# --- the harness --------------------------------------------------------------

@pytest.mark.parametrize("bucket", [64, 16])
def test_bucket_pad_matches_jax(bucket):
    batch = {"image": np.ones((1, 1, 40, 470, 130), np.float32),
             "slo": np.ones((1, 1, 300, 1, 130), np.float32),
             "mask": np.ones((1, 1, 40, 1, 130), np.float32)}
    ref, got = _bucket_pad(batch, bucket), bucket_pad(batch, bucket)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype


def _metrics(torch_device="cpu", hd_device=True):
    kw = dict(output_key="prediction", target_key="mask")
    return {"Dice": streaming.Dice(slice=0, **kw),
            "BCE": streaming.BCE(slice=0, **kw),
            "Precision": streaming.Precision(**kw),
            "Recall": streaming.Recall(**kw),
            "Hausdorff": streaming.Hausdorff(
                slice=0, device=hd_device, torch_device=torch_device, **kw),
            "Hausdorff95": streaming.Hausdorff95(
                slice=0, device=hd_device, torch_device=torch_device, **kw)}


def _image(rng, ident, y, z, x, eh):
    return {"image": rng.normal(size=(1, 1, y, z, x)).astype(np.float32),
            "slo": rng.normal(size=(1, 1, eh, 1, x)).astype(np.float32),
            "mask": (rng.random((1, 1, y, 1, x)) > 0.6).astype(np.float32),
            "spacing": np.array([[0.12, 0.0039, 0.0117]]),
            "FileSetId": [ident]}


def test_metrics_row_matches_jax():
    """One image's row (host metrics, areas) against the JAX harness's
    ``compute_metrics`` on the same prediction."""
    rng = np.random.default_rng(3)
    batch = _image(rng, "a", 8, 16, 32, 16)
    pred = rng.random((1, 1, 8, 1, 32)).astype(np.float32)
    got = compute_metrics({"prediction": pred}, batch,
                          _metrics(hd_device=False), [], {})
    kw = dict(output_key="prediction", target_key="mask")
    jm = {"Dice": jstreaming.Dice(slice=0, **kw),
          "BCE": jstreaming.BCE(slice=0, **kw),
          "Precision": jstreaming.Precision(**kw),
          "Recall": jstreaming.Recall(**kw),
          "Hausdorff": jstreaming.Hausdorff(slice=0, **kw),
          "Hausdorff95": jstreaming.Hausdorff95(slice=0, **kw)}
    rows = []
    jax_compute_metrics({"pred": np.array([]), "gt": np.array([])},
                        {"prediction": pred}, batch, jm, rows, {}, None,
                        save_data=False)
    assert list(got) == list(rows[0])
    for k, v in rows[0].items():
        assert got[k] == v, k
    with pytest.raises(ValueError, match="already"):
        compute_metrics({"prediction": pred}, batch, _metrics(), [],
                        {"a": 1.0})
    # the accumulators: nanmean over the images (an empty mask gives the
    # Hausdorff metrics NaN), as JAX's
    empty = dict(batch, mask=np.zeros_like(batch["mask"]))
    for name, metric in _metrics(hd_device=False).items():
        ref = type(jm[name])(output_key="prediction", target_key="mask")
        for b in (batch, empty):
            metric.update(b, {"prediction": pred})
            ref.update(b, {"prediction": pred})
        np.testing.assert_array_equal(metric.accumulator, ref.accumulator)
        assert metric.get() == ref.get(), name


def test_evaluate_bucketed_rows_match_unbucketed(bucketed_case):
    """``evaluate`` with bucket 64 and ``eval_batch`` 2 (two true shapes,
    each padded, grouped per true shape) against bucket 0: the same rows
    in the same order, the device HD fused into the step."""
    model = build_model(_cfg("relative_2d_max"), spec=bucketed_case["spec"],
                        device="cpu")
    rng = np.random.default_rng(11)
    # (Y, Z, X, en-face H) -> padded (16, 80, 32, 96), and (16, 64, 32, 80)
    # with the en-face map left whole
    shapes = [(8, 72, 32, 88), (8, 72, 32, 88), (12, 64, 32, 80),
              (8, 72, 32, 88)]
    batches = [_image(rng, f"img{i}", *s) for i, s in enumerate(shapes)]
    # the parameter tree does not depend on the input's shape
    sd = state_dict_from_jax(*random_trees(bucketed_case["template"],
                                           seed=12))
    step = make_ensemble_eval_step(model, [sd], device="cpu", with_hd=True)
    plain, _ = evaluate(step, batches, _metrics(), shape_bucket=0)
    bucketed, scores = evaluate(step, batches, _metrics(), shape_bucket=64,
                                eval_batch=2)
    assert [r["FileSetId"] for r in plain] == [f"img{i}" for i in range(4)]
    assert [r["FileSetId"] for r in bucketed] == [r["FileSetId"]
                                                  for r in plain]
    assert set(scores) == {f"img{i}" for i in range(4)}
    for a, b in zip(plain, bucketed):
        assert list(a) == list(b) and len(a) == 10
        for k, v in a.items():
            if isinstance(v, str):
                assert b[k] == v
            else:
                np.testing.assert_allclose(b[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{a['FileSetId']}/{k}")
    # the fused distance equals the metric's own device computation and
    # the host scipy path on the cropped mean prediction
    batch = batches[2]
    out = step({k: batch[k] for k in ("image", "slo", "mask")},
               batch["spacing"][0, [0, 2]])
    host = _metrics(hd_device=False)
    for name, key in (("Hausdorff", "__device_hd__"),
                      ("Hausdorff95", "__device_hd95__")):
        want = host[name].calculate_batch(
            batch, {"prediction": out["prediction"].numpy()})[0]
        np.testing.assert_allclose(float(out[key]), want, rtol=1e-4)
