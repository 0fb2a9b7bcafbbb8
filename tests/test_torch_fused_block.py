"""The port's whole-block eval fusion (``ops/fused_block.py``, K8) against
the JAX package, on the CPU.

Same numpy inputs through both, fp32:

* the plain versions against the JAX kernel bodies in interpret mode:
  ``fused_chain_plain`` against ``fused_chain_eval(..., impl="pallas")``
  in every final mode (``res_conv`` / ``res_id`` with the trailing (3,1,1)
  conv over two Y chunks), ``fused_pair_plain`` against
  ``fused_conv2_eval``, each with and without extents (garbage beyond
  them): 1e-5, the tolerance of ``tests/test_fused_stage.py``;
* FPNHybridFusion with ``block_fusion`` "chain" / "pair" against the JAX
  model under ``MMF_FUSED_CHAIN=1`` / ``MMF_FUSED_PAIR=1`` in fused mode
  "on" (``tiny_spec`` widths, the batch of
  ``tests/test_exact_bucketing.py``), unbucketed and zero-padded with the
  true extents: 1e-4;
* routing: the port's chain / pair calls per member against the JAX
  package's ``fused_chain_eval`` / ``fused_conv2_eval`` calls (spies, at the
  ini widths: 5 each).

The JAX functions are traced in the main thread and compiled side by side
in threads, once per module.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu.config import make_config
from multimodal_fusion_fpn_tpu.models import blocks as jblocks
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.ops.pallas import fused_conv as jfc

from multimodal_fusion_fpn_torch import ops
from multimodal_fusion_fpn_torch.eval.ensemble import make_ensemble_eval_step
from multimodal_fusion_fpn_torch.eval.harness import evaluate
from multimodal_fusion_fpn_torch.models import blocks as tblocks
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.ops import fused_block as tfb
from multimodal_fusion_fpn_torch.weights import state_dict_from_jax

from test_torch_model import compile_ref, random_trees
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# --- the plain versions against the JAX kernel bodies -----------------------

B, Y, X, NB, BS = 1, 4, 3, 4, 8
Z = NB * BS
EXT = (3, 2, 20)
# final mode -> (taps of the convs, entry prologue, ci)
CHAIN_CASES = {"res_conv": (((1, 3, 3), (1, 3, 3), (3, 1, 1)), False, 4),
               "res_id": (((1, 3, 3), (1, 3, 3), (3, 1, 1)), False, 8),
               "relu": (((1, 3, 3), (1, 3, 3)), True, 8),
               "affine": (((1, 3, 3), (1, 3, 3)), True, 4)}
CO = 8


def _arr(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _chain_case(final):
    taps, entry, ci = CHAIN_CASES[final]
    rng = np.random.default_rng(len(final) + ci)
    x = _arr(rng, (B, Y, X, Z, ci))
    s_in = b_in = None
    if entry:
        s_in, b_in = _arr(rng, ci, 0.5) + 1.0, _arr(rng, ci, 0.5)
    convs, c = [], ci
    for k in taps:
        convs.append((_arr(rng, k + (c, CO), 0.3), _arr(rng, CO, 0.3) + 1.0,
                      _arr(rng, CO, 0.3)))
        c = CO
    ds = None
    if final == "res_conv":
        ds = (_arr(rng, (1, 1, 1, ci, CO), 0.3), _arr(rng, CO, 0.3) + 1.0,
              _arr(rng, CO, 0.3))
    return x, s_in, b_in, entry, convs, ds


def _pair_case():
    rng = np.random.default_rng(21)
    ci = 4
    return (_arr(rng, (B, Y, X, Z, ci)), _arr(rng, ci, 0.5) + 1.0,
            _arr(rng, ci, 0.5), _arr(rng, (1, 3, 3, ci, CO), 0.3),
            _arr(rng, CO, 0.3) + 1.0, _arr(rng, CO, 0.3),
            _arr(rng, (1, 3, 3, CO, CO), 0.3))


def _tile(v):
    return None if v is None else jnp.asarray(np.tile(v, BS))


def _jax_chain(final, ext):
    x, s_in, b_in, relu0, convs, ds = _chain_case(final)
    jconvs = [(jnp.asarray(w), _tile(s), _tile(b)) for w, s, b in convs]
    jds = None if ds is None else (jnp.asarray(ds[0]), _tile(ds[1]),
                                   _tile(ds[2]))
    dyn = None if ext is None else tuple(jnp.int32(e) for e in ext)

    def fn(xp):
        y = jfc.fused_chain_eval(xp, _tile(s_in), _tile(b_in), relu0,
                                 jconvs, final, jds, X, NB, BS,
                                 impl="pallas", dyn_extents=dyn)
        return jfc.unpack(y, X, NB, BS)
    return fn, jfc.pack(jnp.asarray(x), BS)


def _jax_pair(ext):
    x, s0, b0, w0, sm, bm, w1 = _pair_case()
    dyn = None if ext is None else tuple(jnp.int32(e) for e in ext)

    def fn(xp):
        y = jfc.fused_conv2_eval(xp, _tile(s0), _tile(b0), jnp.asarray(w0),
                                 _tile(sm), _tile(bm), jnp.asarray(w1), X,
                                 NB, BS, relu0=True, impl="pallas",
                                 dyn_extents=dyn)
        return jfc.unpack(y, X, NB, BS)
    return fn, jfc.pack(jnp.asarray(x), BS)


KERNEL_CASES = [(f, e) for f in CHAIN_CASES for e in (None, EXT)] + [
    ("pair", None), ("pair", EXT)]


def _case_id(case):
    return f"{case[0]}-{'ext' if case[1] else 'whole'}"


def _t(v):
    return None if v is None else torch.from_numpy(v)


@pytest.mark.parametrize("case", KERNEL_CASES, ids=_case_id)
def test_plain_versions_match_jax_kernels(jax_refs, case):
    """The port's plain chain / pair (and the wrapper, on a CPU tensor)
    against the JAX kernel body in interpret mode.  With extents the JAX
    chain leaves garbage beyond them (its caller masks), so both sides
    are compared there after masking; the pair's raw output everywhere."""
    final, ext = case
    ref = jax_refs["kernels"][case]
    if final == "pair":
        x, s0, b0, w0, sm, bm, w1 = map(_t, _pair_case())
        got = tfb.fused_pair_plain(x, s0, b0, w0, sm, bm, w1, True, ext)
        wrapped = tfb.fused_pair(x, s0, b0, w0, sm, bm, w1, True,
                                 dyn_extents=ext)
    else:
        x, s_in, b_in, relu0, convs, ds = _chain_case(final)
        convs = [tuple(map(_t, c)) for c in convs]
        ds = None if ds is None else tuple(map(_t, ds))
        args = (_t(x), _t(s_in), _t(b_in), relu0, convs, final, ds)
        got = tfb.fused_chain_plain(*args, dyn_extents=ext)
        wrapped = tfb.fused_chain(*args, dyn_extents=ext)
        if ext is not None:
            keep = np.zeros(ref.shape, bool)
            keep[:, :ext[0], :ext[1], :ext[2]] = True
            ref = np.where(keep, ref, 0.0)
            assert not got.numpy()[~keep].any()
    assert got.shape == ref.shape == (B, Y, X, Z, CO)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_wrappers_are_eval_only_and_check_their_arguments():
    x, s_in, b_in, relu0, convs, ds = _chain_case("res_conv")
    convs = [tuple(map(_t, c)) for c in convs]
    ds = tuple(map(_t, ds))
    xt = _t(x)
    w_grad = convs[0][0].clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        tfb.fused_chain(xt, None, None, False, [(w_grad,) + convs[0][1:]]
                        + convs[1:], "res_conv", ds)
    with pytest.raises(ValueError, match="requires grad"):
        tfb.fused_pair(xt, None, None, w_grad, convs[0][1], convs[0][2],
                       convs[1][0], False)
    with torch.no_grad():   # a grad-requiring weight is fine without grad
        tfb.fused_chain(xt, None, None, False, [(w_grad,) + convs[0][1:]]
                        + convs[1:], "res_conv", ds)
    with pytest.raises(ValueError, match="final mode"):
        tfb.fused_chain(xt, None, None, False, convs, "raw")
    with pytest.raises(ValueError, match="extents"):
        tfb.fused_chain(xt, None, None, False, convs, "res_conv", ds,
                        dyn_extents=(Y + 1, X, Z))
    with pytest.raises(ValueError, match="block_fusion"):
        tblocks.ConvX(8, 8, ((1, 3, 3),) * 2, fused=True).eval()(
            torch.zeros(1, 2, 3, 4, 8), block_fusion="triple")


@pytest.mark.parametrize("taps", [((1, 3, 3), (3, 1, 1)),
                                  ((1, 1, 3), (1, 3, 3)),
                                  ((1, 3, 3),) * 3])
def test_kernel_checks_reject_what_it_does_not_take(taps):
    """The CUDA-side checks (run here directly): only two (1,3,3) convs or
    (1,3,3), (1,3,3), (3,1,1) have a kernel; channels must chain."""
    x = torch.zeros(1, 2, 3, 8, 16)
    convs = [(torch.zeros(k + (16, 16)), torch.ones(16), torch.zeros(16))
             for k in taps]
    with pytest.raises(ValueError, match="no kernel for"):
        tfb._check("fused_chain", x, None, None, convs, "res_id", None)
    good = [(torch.zeros((1, 3, 3, 16, 16)), torch.ones(16),
             torch.zeros(16))] * 2
    for bad_x, match in ((torch.zeros(1, 2, 3, 8, 8), "chain from"),
                         (torch.zeros(1, 2, 3, 8, 16).transpose(2, 3),
                          "contiguous")):
        with pytest.raises(ValueError, match=match):
            tfb._check("fused_chain", bad_x, None, None, good, "relu", None)


# --- the model --------------------------------------------------------------

MY, MZ, MX, EH = 8, 64, 32, 80
PAD_IMAGE, PAD_SLO = {2: 16, 3: 96, 4: 48}, {2: 96, 4: 48}
ENV = {"chain": "MMF_FUSED_CHAIN", "pair": "MMF_FUSED_PAIR"}


def _pad_to(a, dims):
    pads = [(0, 0)] * a.ndim
    for d, tgt in dims.items():
        pads[d] = (0, tgt - a.shape[d])
    return np.pad(a, pads)


def _cfg():
    return make_config(model="FPNHybridFusion", crop="relative_2d_max",
                       fusion_modality="slo")


def _lower_kernels(submit):
    """Each kernel case's JAX function, the Pallas bodies in interpret mode
    (the chain over two Y chunks of 2 rows, ``MMF_YCHUNK``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(os.environ, "MMF_YCHUNK", "2")
        jfc.set_interpret_mode(True)
        try:
            for final, ext in KERNEL_CASES:
                fn, xp = (_jax_pair(ext) if final == "pair"
                          else _jax_chain(final, ext))
                submit(("kernel", final, ext), jax.jit(fn).lower(xp), (xp,))
        finally:
            jfc.set_interpret_mode(False)


def _lower_models(submit, spec):
    """The tiny model's padded batch under each fusion flag, fused mode
    'on'; returns the inputs and the port's state dict."""
    rng = np.random.default_rng(9)
    batch = {"image": rng.normal(size=(1, 1, MY, MZ, MX)).astype(np.float32),
             "slo": rng.normal(size=(1, 1, EH, 1, MX)).astype(np.float32)}
    padded = {"image": _pad_to(batch["image"], PAD_IMAGE),
              "slo": _pad_to(batch["slo"], PAD_SLO),
              "__valid_image__": np.asarray([MY, MZ, MX], np.int32),
              "__valid_enface__": np.asarray([EH, MX], np.int32)}
    model = jbuild(_cfg(), spec=spec, remat=False)
    template = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False))
    params, stats = random_trees(template, seed=13)
    jb = {k: jnp.asarray(v) for k, v in padded.items()}
    for mode, flag in ENV.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(os.environ, flag, "1")
            submit(("model", mode), jax.jit(lambda p, s, b: model.apply(
                {"params": p, "batch_stats": s}, b,
                train=False)["prediction"]).lower(params, stats, jb),
                (params, stats, jb))
    return {"whole": batch, "padded": padded}, state_dict_from_jax(params,
                                                                   stats)


def _count_jax_calls():
    """Per fusion flag, the JAX package's fused_chain_eval /
    fused_conv2_eval calls in one eval forward of FPNHybridFusion at the
    ini widths (traced, not run)."""
    rng = np.random.default_rng(3)
    batch = {k: jnp.asarray(v) for k, v in {
        "image": rng.normal(size=(1, 1, 8, 64, 32)).astype(np.float32),
        "slo": rng.normal(size=(1, 1, 80, 1, 32)).astype(np.float32)}.items()}
    model = jbuild(_cfg(), remat=False)
    template = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    counts = {}
    for mode, name in (("chain", "fused_chain_eval"),
                       ("pair", "fused_conv2_eval")):
        real, seen = getattr(jfc, name), []

        def spy(*args, real=real, seen=seen, **kw):
            seen.append(kw.get("dyn_extents"))
            return real(*args, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jfc, name, spy)
            mp.setitem(os.environ, ENV[mode], "1")
            jax.eval_shape(lambda v, b: model.apply(v, b, train=False),
                           template, batch)
        counts[mode] = len(seen)
    return counts


@pytest.fixture(scope="module")
def jax_refs(tiny_spec):
    """Every JAX reference of the module: the kernel cases' outputs, the
    tiny model's padded predictions per fusion flag, and the fused calls
    per forward at the ini widths.  Traced here one after another, each
    compiled in a thread as soon as it is traced (fused mode 'on')."""
    prev = jblocks._FUSED_MODE
    jblocks.set_fused_stage_mode("on")
    pending = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            def submit(key, lowered, args):
                pending[key] = (pool.submit(compile_ref, lowered), args)

            inputs, sd = _lower_models(submit, tiny_spec)
            _lower_kernels(submit)
            counts = _count_jax_calls()
            out = {k: np.asarray(f.result()(*args))
                   for k, (f, args) in pending.items()}
    finally:
        jblocks.set_fused_stage_mode(prev)
    return {"kernels": {k[1:]: v for k, v in out.items()
                        if k[0] == "kernel"},
            "models": {k[1]: v for k, v in out.items() if k[0] == "model"},
            "counts": counts, "inputs": inputs, "sd": sd,
            "spec": ArchSpec(tiny_spec.channels)}


def _port(case, batch, kernels=True, block_fusion=None):
    model = build_model(_cfg(), spec=case["spec"], device="cpu")
    model.load_state_dict(case["sd"], strict=True)
    with torch.no_grad():
        return model({k: torch.as_tensor(v) for k, v in batch.items()},
                     kernels=kernels,
                     block_fusion=block_fusion)["prediction"].numpy()


@pytest.mark.parametrize("name", ["whole", "padded"])
@pytest.mark.parametrize("mode", ["chain", "pair"])
def test_fused_model_matches_jax(jax_refs, mode, name):
    """FPNHybridFusion under ``block_fusion`` against the JAX model under
    the matching flag on the padded batch: the whole padded output, and
    the port's run on the unpadded batch against the JAX prediction
    cropped to the true extent (JAX's bucketed run equals its unbucketed
    one to 1e-5, ``tests/test_exact_bucketing.py``)."""
    ref = jax_refs["models"][mode]
    got = _port(jax_refs, jax_refs["inputs"][name], block_fusion=mode)
    if name == "whole":
        ref = ref[:, :, :MY, :, :MX]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_fusion_reaches_the_step_and_the_harness(jax_refs):
    """``make_ensemble_eval_step`` and ``evaluate`` pass ``block_fusion`` to
    the model: the chain runs (spied) and the rows equal the unfused
    ones."""
    rng = np.random.default_rng(4)
    batches = [{"image": rng.normal(size=(1, 1, MY, MZ, MX)).astype(
                    np.float32),
                "slo": rng.normal(size=(1, 1, EH, 1, MX)).astype(np.float32),
                "mask": (rng.random((1, 1, MY, 1, MX)) > 0.6).astype(
                    np.float32),
                "FileSetId": [f"img{i}"]} for i in range(2)]
    model = build_model(_cfg(), spec=jax_refs["spec"], device="cpu")
    step = make_ensemble_eval_step(model, [jax_refs["sd"]] * 2,
                                   device="cpu")
    seen = []
    real = tblocks.fused_chain

    def spy(*args):
        seen.append(args[7])   # ConvX passes the extents eighth
        return real(*args)

    from multimodal_fusion_fpn_torch.metrics import streaming
    metrics = {"Dice": streaming.Dice(output_key="prediction",
                                      target_key="mask", slice=0)}
    ref, _ = evaluate(step, batches, metrics, shape_bucket=64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tblocks, "fused_chain", spy)
        got, _ = evaluate(step, batches, metrics, shape_bucket=64,
                          block_fusion="chain")
    assert len(seen) > 0 and all(e is not None for e in seen)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b["Dice"], a["Dice"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["chain", "pair"])
def test_routing_counts_match_jax(jax_refs, mode, monkeypatch):
    """Per member at the ini widths: the port's fused_chain / fused_pair
    calls equal the JAX package's fused_chain_eval / fused_conv2_eval calls
    in the same forward, 5 each: 3D stage 1's second block and both blocks
    of stages 2 and 3.  The per-conv kernel calls fall to 23 (1,*,*) + 3
    (3,1,1) under the chain and 25 + 6 under the pair."""
    seen = {"fused": 0, "k1": 0, "k2": 0}
    fused_name = "fused_chain" if mode == "chain" else "fused_pair"
    real_fused, real_conv = getattr(tblocks, fused_name), tblocks.fused_conv

    def spy(*args, **kw):
        seen["fused"] += 1
        return real_fused(*args, **kw)

    def conv_spy(x, s, b, w, relu, stride_z=1, dyn_extents=None):
        seen["k2" if w.shape[0] == 3 else "k1"] += 1
        return real_conv(x, s, b, w, relu, stride_z, dyn_extents=dyn_extents)

    monkeypatch.setattr(tblocks, fused_name, spy)
    monkeypatch.setattr(tblocks, "fused_conv", conv_spy)
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(1, 1, 8, 64, 32)).astype(np.float32),
             "slo": rng.normal(size=(1, 1, 80, 1, 32)).astype(np.float32)}
    port = build_model(_cfg(), device="cpu")
    ops.reset_launches()
    with torch.no_grad():
        port({k: torch.from_numpy(v) for k, v in batch.items()},
             block_fusion=mode)
    assert seen["fused"] == jax_refs["counts"][mode] == 5
    assert (seen["k1"], seen["k2"]) == ((23, 3) if mode == "chain"
                                        else (25, 6))
    # on the CPU the wrappers run the plain versions and count nothing
    assert not any(tfb.launches.values()) and not tfb.calls
