"""The port's ops against the JAX package's, on the CPU.

Same numpy inputs through both.  fp32 at rtol = atol = 1e-4 (the
full-model parity tolerance); bf16 by cosine and norm ratio against the
fp32 JAX result, since bf16 rounds at other points in the two packages.
The JAX fused conv runs both as its XLA reference (``impl="ref"``) and as
the Pallas kernel body in interpret mode (``impl="pallas"``).  The CUDA
kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""

import ast
import concurrent.futures
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_fusion_fpn_tpu.models import blocks as jblocks
from multimodal_fusion_fpn_tpu.ops import interpolate as jinterp
from multimodal_fusion_fpn_tpu.ops import pooling as jpooling
from multimodal_fusion_fpn_tpu.ops import upsample as jupsample
from multimodal_fusion_fpn_tpu.ops.pallas import fused_conv as jfc
from multimodal_fusion_fpn_tpu.ops.pallas import pool as jpool

from multimodal_fusion_fpn_torch import ops
from multimodal_fusion_fpn_torch.ops import _build
from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
from multimodal_fusion_fpn_torch.ops import fused_block as tfb
from multimodal_fusion_fpn_torch.ops import fused_conv as tfc
from multimodal_fusion_fpn_torch.ops import pool as tpool
from multimodal_fusion_fpn_torch.ops.interpolate import linear_resize
from multimodal_fusion_fpn_torch.ops.pooling import adaptive_max_pool
from multimodal_fusion_fpn_torch.ops.upsample import upsample_nearest

from rollfree_calls import rollfree_calls  # noqa: F401 (fixture)
from test_torch_model import compile_ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cos_norm(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return cos, np.linalg.norm(a) / np.linalg.norm(b)


def _conv_inputs(B, Y, X, Z, ci, co, kshape, affine, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Y, X, Z, ci)).astype(np.float32)
    s = rng.normal(size=(ci,)).astype(np.float32) if affine else None
    b = rng.normal(size=(ci,)).astype(np.float32) if affine else None
    w = (rng.normal(size=kshape + (ci, co)) * 0.3).astype(np.float32)
    return x, s, b, w


def _jax_fused(x, s, b, w, relu, bs, impl, dtype=jnp.float32):
    B, Y, X, Z, ci = x.shape
    nb = Z // bs
    tile = (lambda v: None if v is None
            else jnp.tile(jnp.asarray(v, dtype), bs))
    y = jfc.fused_conv([jfc.pack(jnp.asarray(x, dtype), bs)], [tile(s)],
                       [tile(b)], jnp.asarray(w, dtype), X, nb, bs,
                       relu=relu, preferred_element_type=dtype, impl=impl)
    return jfc.unpack(y, X, nb, bs)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


# (B, Y, X, Z, kshape): 3D (1,3,3), (3,1,1), 1x1x1, and a 2D (1,3) conv
# as (1,1,3) on the singleton-X view
CONV_CASES = [(1, 4, 6, 16, (1, 3, 3)), (1, 4, 6, 16, (3, 1, 1)),
              (2, 3, 5, 16, (1, 1, 1)), (1, 6, 1, 24, (1, 1, 3))]
# (affine, relu) of the stride-2 cascade cases
CASCADE_MODES = [(True, True), (False, False), (True, False)]


def _fwd_case(case, relu, affine):
    B, Y, X, Z, kshape = case
    return _conv_inputs(B, Y, X, Z, 8, 16, kshape, affine,
                        seed=sum(kshape) + 2 * relu + affine)


def _cascade_case(affine, relu):
    return _conv_inputs(1, 3, 4, 32, 8, 16, (1, 1, 3), affine,
                        seed=11 + affine + 2 * relu)


def _jax_cascade(x, s, b, w, relu, impl, bs=8):
    X, Z = x.shape[2], x.shape[3]
    nb = Z // bs
    tile = lambda v: None if v is None else jnp.tile(v, bs)
    y = jfc.fused_conv_strided([jfc.pack(x, bs)], [tile(s)], [tile(b)], w,
                               X, nb, bs, valid_in=bs, relu=relu, impl=impl)
    return jfc.unpack_slots(y, X, nb, bs, bs // 2)


@pytest.fixture(scope="module")
def jax_forwards(rollfree_calls):
    """The JAX fused conv's output for every case of the two forward tests
    below, keyed ('conv', case, relu, affine, impl) or ('cascade', affine,
    relu, impl): traced one after another (the Pallas cases in interpret
    mode, counted by ``rollfree_calls``: none takes a roll-free body),
    compiled side by side in threads.  The roll-free forward's references
    come with its backward's (``jax_vjps``)."""
    jobs = [(("conv", c, r, a, i), _fwd_case(c, r, a),
             lambda x, s, b, w, r=r, i=i: _jax_fused(x, s, b, w, r, 8, i))
            for c in CONV_CASES for r in (True, False)
            for a in (True, False) for i in ("ref", "pallas")]
    jobs += [(("cascade", a, r, i), _cascade_case(a, r),
              lambda x, s, b, w, r=r, i=i: _jax_cascade(x, s, b, w, r, i))
             for a, r in CASCADE_MODES for i in ("ref", "pallas")]
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for key, inputs, fn in jobs:
            args = [None if a is None else jnp.asarray(a) for a in inputs]
            with rollfree_calls.trace(key, False):
                jfc.set_interpret_mode(key[-1] == "pallas")
                try:
                    lowered = jax.jit(fn).lower(*args)
                finally:
                    jfc.set_interpret_mode(False)
            pending[key] = (pool.submit(compile_ref, lowered), args)
        return {k: np.asarray(c.result()(*args), np.float32)
                for k, (c, args) in pending.items()}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: "k" + "".join(map(str, c[4])))
def test_fused_conv_matches_jax(case, relu, affine, impl, jax_forwards):
    x, s, b, w = _fwd_case(case, relu, affine)
    ref = jax_forwards[("conv", case, relu, affine, impl)]
    got = tfc.fused_conv(_t(x), _t(s), _t(b), _t(w), relu).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kshape", [(1, 3, 3), (3, 1, 1)])
def test_fused_conv_bf16_matches_jax_fp32(kshape):
    x, s, b, w = _conv_inputs(2, 4, 6, 16, 16, 16, kshape, True, seed=7)
    ref = _jax_fused(x, s, b, w, True, bs=8, impl="ref")
    bf = torch.bfloat16
    got = tfc.fused_conv(_t(x, bf), _t(s, bf), _t(b, bf), _t(w, bf), True)
    assert got.dtype == bf
    cos, ratio = _cos_norm(got.float().numpy(), ref)
    assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (cos, ratio)


def test_padding_reads_zero_not_relu_bias():
    """Out-of-range taps read 0: with x = 0 and bias 1 the activated input
    is 1 inside the volume, so a corner output of a (1,3,3) all-ones conv
    sums 4 taps (not 9)."""
    x = torch.zeros(1, 1, 3, 3, 8)
    out = tfc.fused_conv(x, torch.ones(8), torch.ones(8),
                         torch.ones(1, 3, 3, 8, 16), True)
    assert out[0, 0, 0, 0, 0].item() == 4 * 8
    assert out[0, 0, 1, 1, 0].item() == 9 * 8


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("affine,relu", CASCADE_MODES)
def test_stride2_cascade_matches_jax(affine, relu, impl, jax_forwards):
    """The stride-2 (1,1,3) cascade conv vs ``fused_conv_strided`` on a
    dense input (valid_in = bs) read back with ``unpack_slots``."""
    x, s, b, w = _cascade_case(affine, relu)
    ref = jax_forwards[("cascade", affine, relu, impl)]
    got = tfc.fused_conv(_t(x), _t(s), _t(b), _t(w), relu, stride_z=2)
    assert got.shape == (1, 3, 4, 16, 16)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_stride2_odd_depth_length():
    x = torch.randn(1, 2, 2, 31, 8)
    got = tfc.fused_conv(x, None, None, torch.randn(1, 1, 3, 8, 16), False,
                         stride_z=2)
    assert got.shape[3] == 16


# --- training: the stats epilogue and the backward (K3, K4, K6) ------------
#
# The JAX side is ``fused_conv`` / ``fused_conv_strided`` (out_stats) on a
# dense packed input; its per-lane (1, bs*co) stats are summed to
# per-channel inside the differentiated function, so the per-channel
# cotangents (gs1, gs2) apply to both sides as they are.

def _assert_rel(got, ref, what=""):
    """max|got - ref| <= 1e-4 * max|ref| (the fp32 tolerance)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), (what, err,
                                                          np.abs(ref).max())


def _jax_conv_fn(X, Z, bs, relu, stride_z, stats, impl):
    """f(x, s, b, w) -> y (B, Y, X, Zo, co) [, s1, s2 per channel]."""
    nb = Z // bs

    def f(x, s, b, w):
        tile = lambda v: None if v is None else jnp.tile(v, bs)
        args = ([jfc.pack(x, bs)], [tile(s)], [tile(b)], w, X, nb, bs)
        if stride_z == 1:
            out = jfc.fused_conv(*args, relu=relu, impl=impl,
                                 out_stats=stats)
        else:
            out = jfc.fused_conv_strided(*args, valid_in=bs, relu=relu,
                                         impl=impl, out_stats=stats)
        y = out[0] if stats else out
        y = (jfc.unpack(y, X, nb, bs) if stride_z == 1
             else jfc.unpack_slots(y, X, nb, bs, bs // 2))
        if not stats:
            return y
        return (y, out[1].reshape(bs, -1).sum(0),
                out[2].reshape(bs, -1).sum(0))
    return f


def _jax_conv_vjp(X, Z, bs, relu, stride_z, stats, impl, affine):
    """f(x, w, s, b, g, gs1, gs2) -> (out, grads): the JAX fused conv's
    output and its jax.vjp for the cotangent g (with (gs1, gs2) on the
    stats), grads (dx, dw[, ds, db])."""
    f = _jax_conv_fn(X, Z, bs, relu, stride_z, stats, impl)

    def run(x, w, s, b, g, gs1, gs2):
        if affine:
            out, pull = jax.vjp(lambda x_, w_, s_, b_: f(x_, s_, b_, w_),
                                x, w, s, b)
        else:
            out, pull = jax.vjp(lambda x_, w_: f(x_, None, None, w_), x, w)
        return out, pull((g, gs1, gs2) if stats else g)
    return run


# (taps, z stride): the (1,3,3) stage conv, the 2D (1,3) / 3D (1,1,3) convs,
# the stride-2 cascade conv, the 1x1x1 downsample and the (3,1,1) conv (K4)
BWD_CASES = [((1, 3, 3), 1), ((1, 1, 3), 1), ((1, 1, 3), 2), ((1, 1, 1), 1),
             ((3, 1, 1), 1)]


def _bwd_inputs(kshape, stride_z, affine, seed, Z=16, Y=4):
    B, X, ci, co = 1, 4, 8, 16
    x, s, b, w = _conv_inputs(B, Y, X, Z, ci, co, kshape, affine, seed)
    rng = np.random.default_rng(seed + 100)
    Zo = (Z - 1) // stride_z + 1
    g = rng.normal(size=(B, Y, X, Zo, co)).astype(np.float32)
    gs1 = rng.normal(size=(co,)).astype(np.float32)
    gs2 = (0.1 * rng.normal(size=(co,))).astype(np.float32)
    return x, s, b, w, g, gs1, gs2


def _port_bwd(x, s, b, w, g, gs1, gs2, relu, stride_z, stats):
    """The port's (y, s1, s2, dx, ds, db, dw) twice: fused_conv_bwd_plain,
    and autograd through the FusedConv Function."""
    t = [_t(a) for a in (x, s, b, w, g, gs1, gs2)]
    x_, s_, b_, w_, g_, gs1_, gs2_ = t
    y, s1, s2 = tfc.fused_conv(x_, s_, b_, w_, relu, stride_z,
                               with_stats=True)
    cot = (y, gs1_, gs2_) if stats else None
    plain = tfc.fused_conv_bwd_plain(x_, s_, b_, w_, g_, relu, stride_z, cot)
    leaves = [a.clone().requires_grad_() if a is not None else None
              for a in (x_, s_, b_, w_)]
    out = tfc.fused_conv(*leaves, relu, stride_z, with_stats=stats)
    loss = ((out[0] * g_).sum() + (out[1] * gs1_).sum()
            + (out[2] * gs2_).sum()) if stats else (out * g_).sum()
    need = [a for a in leaves if a is not None]
    got = iter(torch.autograd.grad(loss, need))
    auto = [next(got) if a is not None else None for a in leaves]
    auto = (auto[0], auto[1], auto[2], auto[3])
    return (y, s1, s2), plain, auto


_BWD_IMPLS = ("ref", "pallas")
_BWD_MODES = ((True, True), (False, False))   # (affine, relu)
# K9: the roll-free bodies (MMF_ROLLFREE=1) on the (1,3,3) conv, (affine,
# relu, stats): affine + ReLU without the stats and identity with them, at
# a Y whose grid step holds G = 2 rows (the trace unrolls G)
RF_BWD_CASES = [(True, True, False), (False, False, True)]
RF_Y = 2


def _bwd_seed(kshape, stride_z, affine, stats, split):
    if split:
        return 40 + sum(kshape) + stride_z
    return sum(kshape) + 3 * stride_z + 5 * affine + 7 * stats


@pytest.fixture(scope="module")
def jax_vjps(rollfree_calls):
    """(y, s1, s2, dx, ds, db, dw) of jax.vjp of the JAX fused conv, numpy,
    for every case of the backward tests below, keyed (kshape, stride_z,
    affine, relu, stats, impl, split): traced one after another (the Pallas
    cases in interpret mode, impl 'rollfree' the Pallas ones with
    MMF_ROLLFREE=1, counted by ``rollfree_calls``, the split ones with
    MMF_MERGED_BWD=0, all read while tracing), compiled side by side in
    threads."""
    # the costliest compiles first, so they overlap the other traces
    cases = [((1, 3, 3), 1, a, r, st, "rollfree", False)
             for a, r, st in RF_BWD_CASES]
    cases += [(k, sz, True, True, True, "pallas", True)
              for k, sz in BWD_CASES]
    cases += [(k, sz, a, r, st, impl, False) for k, sz in BWD_CASES
              for a, r in _BWD_MODES for st in (False, True)
              for impl in _BWD_IMPLS]
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for case in cases:
            kshape, stride_z, affine, relu, stats, impl, split = case
            x, s, b, w, g, gs1, gs2 = _bwd_inputs(
                kshape, stride_z, affine,
                _bwd_seed(kshape, stride_z, affine, stats, split),
                Y=RF_Y if impl == "rollfree" else 4)
            args = [jnp.asarray(a) if a is not None else None
                    for a in (x, w, s, b, g, gs1, gs2)]
            pallas = impl != "ref"
            fn = _jax_conv_vjp(4, 16, 8, relu, stride_z, stats,
                               "pallas" if pallas else "ref", affine)
            with rollfree_calls.trace(case, impl == "rollfree"), \
                    pytest.MonkeyPatch.context() as mp:
                if split:
                    mp.setenv("MMF_MERGED_BWD", "0")
                jfc.set_interpret_mode(pallas)
                try:
                    lowered = jax.jit(fn).lower(*args)
                finally:
                    jfc.set_interpret_mode(False)
            pending[case] = (pool.submit(compile_ref, lowered), args)
        refs = {}
        for case, (compiled, args) in pending.items():
            out, grads = compiled.result()(*args)
            out = [np.asarray(o) for o in (out if case[4] else (out,))]
            grads = [np.asarray(a) for a in grads]
            y, s1, s2 = (out + [None, None])[:3]
            ds, db = grads[2:] if case[2] else (None, None)
            refs[case] = (y, s1, s2, grads[0], ds, db, grads[1])
    return refs


def _check_bwd_case(kshape, stride_z, affine, relu, stats, ref, Y=4):
    """The port's stats forward, plain backward and autograd Function
    against one jax.vjp reference (``jax_vjps``)."""
    x, s, b, w, g, gs1, gs2 = _bwd_inputs(
        kshape, stride_z, affine,
        _bwd_seed(kshape, stride_z, affine, stats, False), Y=Y)
    fwd, plain, auto = _port_bwd(x, s, b, w, g, gs1, gs2, relu, stride_z,
                                 stats)
    _assert_rel(fwd[0].numpy(), ref[0], "y")
    if stats:
        _assert_rel(fwd[1].numpy(), ref[1], "s1")
        _assert_rel(fwd[2].numpy(), ref[2], "s2")
    for name, i in (("dx", 3), ("ds", 4), ("db", 5), ("dw", 6)):
        for how, got in (("plain", plain), ("autograd", auto)):
            j = i - 3
            if ref[i] is None:
                assert got[j] is None, (how, name)
            else:
                _assert_rel(got[j].detach().numpy(), ref[i], f"{how} {name}")


@pytest.mark.parametrize("impl", _BWD_IMPLS)
@pytest.mark.parametrize("stats", [False, True], ids=["g", "g+stats"])
@pytest.mark.parametrize("affine,relu", _BWD_MODES,
                         ids=["affine_relu", "identity"])
@pytest.mark.parametrize("kshape,stride_z", BWD_CASES,
                         ids=lambda c: "".join(map(str, c))
                         if isinstance(c, tuple) else f"s{c}")
def test_fused_conv_bwd_matches_jax_vjp(kshape, stride_z, affine, relu,
                                        stats, impl, jax_vjps):
    """dx, ds, db, dw of the plain backward and of the autograd Function
    against jax.vjp of the JAX fused conv (the XLA reference, or the Pallas
    merged backward K3/K4 in interpret mode), with and without the stats
    cotangent; the stats forward against ``out_stats``."""
    _check_bwd_case(kshape, stride_z, affine, relu, stats,
                    jax_vjps[(kshape, stride_z, affine, relu, stats, impl,
                              False)])


_RF_IDS = ["affine_relu-g", "identity-g+stats"]


@pytest.mark.parametrize("affine,relu,stats", RF_BWD_CASES, ids=_RF_IDS)
def test_fused_conv_matches_jax_rollfree_body(affine, relu, stats,
                                              jax_vjps, rollfree_calls):
    """K9 forward: the port's plain version (``fused_conv`` on CPU
    tensors, with the stats where the case has them) against the roll-free
    Pallas body ``_rf_kernel`` in interpret mode (MMF_ROLLFREE=1), which
    ran, at a Y whose grid step holds G > 1 rows: affine + ReLU without
    the stats, identity with them.  The CUDA forward (``csrc/fused_conv.cu``)
    computes this function; the card holds it against the plain version
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
    key = ((1, 3, 3), 1, affine, relu, stats, "rollfree", False)
    assert rollfree_calls.by_case[key]["_rf_kernel"] > 0
    x, s, b, w, _, _, _ = _bwd_inputs(
        (1, 3, 3), 1, affine, _bwd_seed((1, 3, 3), 1, affine, stats, False),
        Y=RF_Y)
    B, Y, X, Z, ci = x.shape
    assert jfc._g1_G(Y, X * (Z // 8), 8 * w.shape[-1], 4, rf=True) > 1
    ref = jax_vjps[key]
    got = tfc.fused_conv(_t(x), _t(s), _t(b), _t(w), relu,
                         with_stats=stats)
    for name, a, r in zip(("y", "s1", "s2"), got if stats else (got,), ref):
        np.testing.assert_allclose(a.numpy(), r, **TOL, err_msg=name)


@pytest.mark.parametrize("affine,relu,stats", RF_BWD_CASES, ids=_RF_IDS)
def test_fused_conv_bwd_matches_jax_rollfree_body(affine, relu, stats,
                                                  jax_vjps, rollfree_calls):
    """K9 backward: the plain backward and the autograd Function against
    jax.vjp through the roll-free bodies in interpret mode (MMF_ROLLFREE=1:
    ``_rf_kernel`` forward and the merged ``_rf_dx_kernel``, whose band
    cotangent is dw), which both ran, without and with the stats
    cotangent.  The CUDA backward (``csrc/fused_conv_bwd.cu``, bf16
    ``csrc/fused_conv_bwd_mma.cu``) computes this function; the card holds
    it against the plain version."""
    key = ((1, 3, 3), 1, affine, relu, stats, "rollfree", False)
    calls = rollfree_calls.by_case[key]
    assert calls["_rf_kernel"] > 0 and calls["_rf_dx_kernel"] > 0, calls
    _check_bwd_case((1, 3, 3), 1, affine, relu, stats, jax_vjps[key], Y=RF_Y)


def test_rollfree_bodies_ran_only_under_the_flag(jax_forwards, jax_vjps,
                                                 rollfree_calls):
    """The counting wrappers saw the roll-free bodies in every roll-free
    case and in no default case (forward and backward references)."""
    assert any("rollfree" in k for k in rollfree_calls.by_case)
    rollfree_calls.check()


@pytest.mark.parametrize("kshape,stride_z", BWD_CASES,
                         ids=lambda c: "".join(map(str, c))
                         if isinstance(c, tuple) else f"s{c}")
def test_split_wgrad_matches_jax_dband_kernel(kshape, stride_z, jax_vjps):
    """K6: with MMF_MERGED_BWD=0 the JAX backward takes the split path,
    whose weight cotangent comes from ``_dband_pallas`` (``_dband_kernel``
    / ``_yck_dband_kernel``) in interpret mode; the port's dw (the wgrad
    function) must agree, with the stats cotangent folded in."""
    x, s, b, w, g, gs1, gs2 = _bwd_inputs(
        kshape, stride_z, True, _bwd_seed(kshape, stride_z, True, True, True))
    ref = jax_vjps[(kshape, stride_z, True, True, True, "pallas", True)]
    _, plain, auto = _port_bwd(x, s, b, w, g, gs1, gs2, True, stride_z,
                               True)
    for name, i in (("dx", 0), ("ds", 1), ("db", 2), ("dw", 3)):
        _assert_rel(plain[i].numpy(), ref[3 + i], f"plain {name}")
        _assert_rel(auto[i].numpy(), ref[3 + i], f"autograd {name}")


@pytest.mark.parametrize("Z", [31, 32, 29])
@pytest.mark.parametrize("stats", [False, True])
def test_stride2_bwd_odd_depth_matches_torch_autograd(Z, stats):
    """The stride-2 transposed conv at odd and even depths: the plain
    backward and the Function against torch's own autograd of the plain
    forward (z_in = 2 z_out + dz - 1)."""
    x, s, b, w, g, gs1, gs2 = _bwd_inputs((1, 1, 3), 2, True, seed=Z,
                                          Z=Z)
    fwd, plain, auto = _port_bwd(x, s, b, w, g, gs1, gs2, True, 2, stats)
    leaves = [_t(a).requires_grad_() for a in (x, s, b, w)]
    y, s1, s2 = tfc.fused_conv_plain(*leaves, True, 2, with_stats=True)
    loss = (y * _t(g)).sum()
    if stats:
        loss = loss + (s1 * _t(gs1)).sum() + (s2 * _t(gs2)).sum()
    ref = torch.autograd.grad(loss, leaves)
    for i, name in enumerate(("dx", "ds", "db", "dw")):
        _assert_rel(plain[i].numpy(), ref[i].numpy(), f"plain {name}")
        _assert_rel(auto[i].numpy(), ref[i].numpy(), f"autograd {name}")


def test_fused_conv_bwd_bf16_close_to_fp32():
    """bf16 backward: dw is rounded to bf16 like the JAX band cotangent;
    every output agrees with the fp32 plain backward by cosine."""
    x, s, b, w, g, gs1, gs2 = _bwd_inputs((1, 3, 3), 1, True, seed=3)
    ref = tfc.fused_conv_bwd_plain(*(_t(a) for a in (x, s, b, w, g)), True)
    bf = torch.bfloat16
    got = tfc.fused_conv_bwd_plain(*(_t(a, bf) for a in (x, s, b, w, g)),
                                   True)
    assert got[0].dtype == got[3].dtype == bf
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, r in zip(got, ref):
        cos, ratio = _cos_norm(a.float().numpy(), r.numpy())
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (cos, ratio)


@pytest.mark.parametrize("bad,match", [
    (dict(ci=8), "ci % 16"),
    (dict(g_shape=(1, 2, 3, 7, 16)), "g must be"),
    (dict(gs_dtype=torch.bfloat16), "gs1 must be"),
])
def test_fused_conv_bwd_launch_checks(bad, match):
    ci = bad.get("ci", 16)
    x = torch.randn(1, 2, 3, 8, ci)
    w = torch.randn(1, 3, 3, ci, 16)
    g = torch.randn(*bad.get("g_shape", (1, 2, 3, 8, 16)))
    gs = torch.randn(16, dtype=bad.get("gs_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        tfc._check_bwd(x, w, 1, g, (torch.randn(1, 2, 3, 8, 16), gs, gs))


# windows of the main path: 3D (1,2,2), (2,2,2); 2D (1,2), (2,2) as
# (1,1,2), (2,1,2) on the singleton-X view
@pytest.mark.parametrize("win", [(1, 2, 2), (2, 2, 2), (1, 1, 2),
                                 (2, 1, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_matches_jax_pool_packed(win, dtype):
    """Exact, NaN included: a window that holds a NaN pools to NaN, as
    ``jnp.maximum`` in the Pallas kernel gives it (``_plant_nan``)."""
    rng = np.random.default_rng(sum(win))
    X = 1 if win[1] == 1 else 6
    x = _plant_nan(rng.normal(size=(2, 4, X, 32, 16)).astype(np.float32),
                   win)
    bs = 8
    xj = jnp.asarray(x, dtype)
    out = jpool.pool_packed(jfc.pack(xj, bs), X, 32 // bs, bs, win)
    ref = np.asarray(jfc.unpack(out, X // win[1], 32 // bs, bs // win[2]),
                     np.float32)
    tdt = getattr(torch, dtype)
    got = tpool.max_pool3d_cl(torch.from_numpy(x).to(tdt), win)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def _plant_nan(x, win):
    """x with NaN at the first and the last position of window 0 (channel
    0) and at the last position of the last window (channel 5); the other
    windows keep their values."""
    wy, wx, wz = win
    B, Y, X, Z, C = x.shape
    x = x.copy()
    x[0, 0, 0, 0, 0] = np.nan
    x[0, wy - 1, wx - 1, wz - 1, 0] = np.nan
    x[B - 1, Y // wy * wy - 1, X // wx * wx - 1, Z // wz * wz - 1, 5] = np.nan
    return x


def _tied(shape, seed, signed_zero=True):
    """Values on a coarse grid, so windows hold exact ties; with
    ``signed_zero`` both +0 and -0 occur."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2, 3, size=shape).astype(np.float32)
    if signed_zero:
        v = np.where(rng.random(shape) < 0.5, v, -v)
    return v.astype(np.float32)


def _port_pool_vjp(x, g, win, first_max=False):
    """dx of the port's pool: the plain backward and the autograd Function
    (both on CPU tensors)."""
    xt, gt = torch.tensor(x), torch.tensor(g)
    y = tpool.max_pool3d_cl(xt, win, first_max)
    xg = xt.clone().requires_grad_()
    tpool.max_pool3d_cl(xg, win, first_max).backward(gt)
    plain = (tpool.max_pool3d_cl_bwd_first(xt, gt, win) if first_max
             else tpool.max_pool3d_cl_bwd_plain(xt, y, gt, win))
    return plain.numpy(), xg.grad.numpy()


@pytest.mark.parametrize("win", [(1, 2, 2), (2, 2, 2), (1, 1, 2),
                                 (2, 1, 2)])
def test_max_pool_bwd_matches_jax_pool_packed_on_ties(win):
    """K5b's rule: the Pallas pool's backward (``_bwd_row_kernel`` /
    ``_bwd_kernel``, interpreted off-TPU) gives g to every tied max, and
    to every NaN input of a window whose max is NaN (its bit compare, with
    the NaNs of one bit pattern; ``_plant_nan``); the port's plain
    backward and its Function agree exactly.  (Signed zeros: next test.)"""
    X = 1 if win[1] == 1 else 6
    x = _plant_nan(_tied((2, 4, X, 32, 16), seed=sum(win),
                         signed_zero=False), win)
    bs, nb = 8, 4
    f = lambda v: jpool.pool_packed(jfc.pack(v, bs), X, nb, bs, win)
    y, pull = jax.vjp(f, jnp.asarray(x))
    g = np.random.default_rng(1).normal(size=y.shape).astype(np.float32)
    ref = np.asarray(pull(jnp.asarray(g))[0])
    assert np.count_nonzero(ref) > np.count_nonzero(g)  # ties occur
    g_cl = np.asarray(jfc.unpack(jnp.asarray(g), X // win[1], nb,
                                 bs // win[2]))
    assert (ref[np.isnan(x)] != 0).all()  # every NaN input takes g
    for got in _port_pool_vjp(x, g_cl, win):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("win", [(2, 2, 2), (1, 1, 2)])
def test_max_pool_bwd_signed_zero_ties_follow_tie_mask(win):
    """+0 and -0 tie: the backward routes g by the Pallas kernel's
    ``_tie_mask`` (fp32 bit patterns after ``+ 0.0``), evaluated here
    eagerly.  Under jit XLA folds ``x + 0.0`` to ``x``, so the interpreted
    kernel itself would split the two zeros; the rule is the eager one."""
    x = _tied((2, 4, 6, 32, 16), seed=7 + sum(win))
    y = tpool.max_pool3d_cl(torch.from_numpy(x), win)
    g = np.random.default_rng(3).normal(size=y.shape).astype(np.float32)
    B, Yo, Xo, Zo, C = y.shape
    at = lambda t: np.asarray(t).reshape(B, Yo, 1, Xo, 1, Zo, 1, C)
    xw = x[:, :Yo * win[0], :Xo * win[1], :Zo * win[2]].reshape(
        B, Yo, win[0], Xo, win[1], Zo, win[2], C)
    tie = np.asarray(jpool._tie_mask(jnp.asarray(xw), jnp.asarray(at(y))))
    ref = np.where(tie, at(g), 0.0).reshape(x.shape).astype(np.float32)
    signed = (x == 0) & np.signbit(x)
    assert (ref[signed] != 0).any()  # some -0 takes g from a +0 max
    for got in _port_pool_vjp(x, g, win):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("win", [(1, 2, 2), (2, 2, 2)])
def test_max_pool_first_max_bwd_matches_jax_reduce_window(win):
    """The stage-4 rule: XLA's reduce_window max VJP (``blocks.max_pool``)
    gives g to the first max in (Y, X, Z) window order only."""
    x = _tied((2, 4, 6, 10, 128), seed=5 + sum(win))
    y, pull = jax.vjp(lambda v: jblocks.max_pool(v, win), jnp.asarray(x))
    g = np.random.default_rng(2).normal(size=y.shape).astype(np.float32)
    ref = np.asarray(pull(jnp.asarray(g))[0])
    assert np.count_nonzero(ref) == np.count_nonzero(g)
    for got in _port_pool_vjp(x, g, win, first_max=True):
        np.testing.assert_array_equal(got, ref)


def test_max_pool_plain_backward_is_not_amax_split():
    """An all-equal window: all ties give g to all 8 elements, first max to
    element 0 only (``amax`` autograd would give each 1/8)."""
    x = torch.zeros(1, 2, 2, 2, 1)
    for first_max, want in ((False, [1.0] * 8), (True, [1.0] + [0.0] * 7)):
        xg = x.clone().requires_grad_()
        tpool.max_pool3d_cl_plain(xg, (2, 2, 2), first_max).sum().backward()
        assert xg.grad.flatten().tolist() == want


def test_max_pool_floor_sizes():
    x = torch.randn(1, 5, 7, 9, 4)
    got = tpool.max_pool3d_cl(x, (2, 2, 2))
    ref = torch.nn.functional.max_pool3d(x.permute(0, 4, 1, 2, 3), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.permute(0, 2, 3, 4, 1).numpy())


def test_cpu_wrappers_take_plain_path_and_count_nothing():
    ops.reset_launches()
    x = torch.randn(1, 2, 3, 8, 16)
    w = torch.randn(1, 3, 3, 16, 16)
    s, b = torch.randn(16), torch.randn(16)
    torch.testing.assert_close(tfc.fused_conv(x, s, b, w, True),
                               tfc.fused_conv_plain(x, s, b, w, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(tpool.max_pool3d_cl(x, (1, 1, 2)),
                               tpool.max_pool3d_cl_plain(x, (1, 1, 2)),
                               rtol=0, atol=0)
    y, s1, s2 = tfc.fused_conv(x, s, b, w, True, with_stats=True)
    g = torch.randn_like(y)
    for got, want in zip(
            tfc.fused_conv_bwd(x, s, b, w, g, True),
            tfc.fused_conv_bwd_plain(x, s, b, w, g, True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        tfc.fused_conv(x, s, b, w, True, dyn_extents=(1, 2, 5)),
        tfc.fused_conv_dyn_plain(x, s, b, w, True, 1, (1, 2, 5)),
        rtol=0, atol=0)
    xp = tpool.max_pool3d_cl(x, (1, 1, 2))
    torch.testing.assert_close(
        tpool.max_pool3d_cl_bwd(x, xp, xp, (1, 1, 2)),
        tpool.max_pool3d_cl_bwd_plain(x, xp, xp, (1, 1, 2)), rtol=0, atol=0)
    # the autograd Functions on CPU tensors run the plain versions too
    xg = x.clone().requires_grad_()
    tfc.fused_conv(xg, s, b, w, True, with_stats=True)[1].sum().backward()
    tpool.max_pool3d_cl(xg, (1, 1, 2)).sum().backward()
    # the whole-block wrappers (K8) too
    convs = [(w, s, b), (w, s, b)]
    torch.testing.assert_close(
        tfb.fused_chain(x, None, None, False, convs, "res_id"),
        tfb.fused_chain_plain(x, None, None, False, convs, "res_id"),
        rtol=0, atol=0)
    torch.testing.assert_close(
        tfb.fused_pair(x, s, b, w, s, b, w, True, dyn_extents=(1, 2, 5)),
        tfb.fused_pair_plain(x, s, b, w, s, b, w, True, (1, 2, 5)),
        rtol=0, atol=0)
    # the banded conv (K10), its extents instance and both gradients
    x1, w1 = x[..., :1].contiguous(), w[..., :1, :]
    torch.testing.assert_close(tbc.banded_conv(x1, w1, (1, 2, 5)),
                               tbc.banded_conv_plain(x1, w1, (1, 2, 5)),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        tbc.banded_conv_wgrad(x1, g, w1.shape),
        tbc.banded_conv_wgrad_plain(x1, g, w1.shape), rtol=0, atol=0)
    tbc.banded_conv(x1.clone().requires_grad_(), w1).sum().backward()
    launches = ops.kernel_launches()
    assert set(launches) == {
        "fused_conv", "fused_conv_ky3", "fused_conv_stats",
        "fused_conv_ky3_stats", "fused_conv_dgrad", "fused_conv_wgrad",
        "fused_conv_ky3_dgrad", "fused_conv_ky3_wgrad", "fused_conv_dyn",
        "fused_conv_dyn_ky3", "max_pool3d_cl", "max_pool3d_cl_bwd",
        "fused_chain", "fused_pair", "fused_chain_dyn", "fused_pair_dyn",
        "banded_conv", "banded_conv_dyn", "banded_conv_wgrad",
        "banded_conv_dgrad"}
    assert not any(launches.values()), launches
    assert not tfc.calls and not tpool.calls and not tfb.calls
    assert not tbc.calls


@pytest.mark.parametrize("bad,match", [
    (dict(w=torch.randn(3, 3, 3, 8, 16)), "no kernel for taps"),
    (dict(w=torch.randn(1, 3, 3, 4, 16), x=torch.randn(1, 2, 3, 8, 4)),
     "ci % 8"),
    (dict(w=torch.randn(1, 3, 3, 8, 12)), "co % 16"),
    (dict(s=None), "both"),
    (dict(s=torch.randn(8, dtype=torch.float64)), "scale"),
    (dict(x=torch.randn(1, 2, 3, 8, 8).transpose(1, 2)), "contiguous"),
    (dict(stride_z=3), "no kernel for taps"),
])
def test_fused_conv_launch_checks(bad, match):
    args = dict(x=torch.randn(1, 2, 3, 8, 8), s=torch.randn(8),
                b=torch.randn(8), w=torch.randn(1, 3, 3, 8, 16), stride_z=1)
    args.update(bad)
    with pytest.raises((ValueError, TypeError), match=match):
        tfc._check(args["x"], args["s"], args["b"], args["w"],
                   args["stride_z"])


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc, no kernel: the build raises instead of falling back."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["pool"])


def test_library_path_tracks_source(tmp_path, monkeypatch):
    a = _build.library_path("fused_conv")
    assert a.startswith(_build.BUILD_DIR) and a.endswith(".so")
    assert a != _build.library_path("pool")
    src = tmp_path / "fused_conv.cu"
    src.write_text("// changed\n")
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    assert _build.library_path("fused_conv") != a


@pytest.mark.parametrize("scale,axes", [((2, 2, 1), (1, 2, 3)),
                                        ((1, 2, 1), (1, 2, 3))])
def test_upsample_matches_jax(scale, axes):
    x = np.random.default_rng(0).normal(size=(1, 3, 4, 1, 5)).astype(
        np.float32)
    ref = np.asarray(jupsample.upsample_nearest(jnp.asarray(x), scale, axes))
    got = upsample_nearest(torch.from_numpy(x), scale, axes).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,out", [((1, 80, 32, 1, 4), (8, 32, 1)),
                                       ((1, 10, 7, 1, 3), (4, 3, 1))])
def test_adaptive_max_pool_matches_jax(shape, out):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = np.asarray(jpooling.adaptive_max_pool(jnp.asarray(x), out,
                                                axes=(1, 2, 3)))
    got = adaptive_max_pool(torch.from_numpy(x), out, axes=(1, 2, 3))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape,out", [((1, 80, 32, 1, 4), (8, 32, 1)),
                                       ((1, 10, 7, 1, 3), (4, 11, 1))])
def test_linear_resize_matches_jax(shape, out):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = np.asarray(jinterp.linear_resize(jnp.asarray(x), out,
                                           axes=(1, 2, 3)))
    got = linear_resize(torch.from_numpy(x), out, axes=(1, 2, 3))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root,
                                            "multimodal_fusion_fpn_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax",
                               "multimodal_fusion_fpn_tpu"), (path, mod)


def _passes_tensor_cores(path):
    """The lines of ``path`` whose calls pass a ``tensor_cores`` argument
    (by keyword, or by a name or attribute of that name)."""
    tree = ast.parse(open(path).read(), path)
    lines = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        args = list(node.args) + [k.value for k in node.keywords]
        named = [k.arg for k in node.keywords] + [
            a.id if isinstance(a, ast.Name) else
            a.attr if isinstance(a, ast.Attribute) else None for a in args]
        if "tensor_cores" in named:
            lines.append(node.lineno)
    return lines


def test_model_paths_never_pass_tensor_cores():
    """``tensor_cores`` (the private A/B switch of the fused-conv
    launchers, of ``fused_block._launch`` and ``fused_block.plan``, and of
    ``fused_block``'s per-conv path) is passed only by the ops themselves,
    ``chip_smoke.py``, ``tools/block_ab.py`` and the card tests: nothing
    under ``models``, ``eval`` or ``train`` passes it, so the model's paths
    always take the tensor cores in bf16."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tfc.__file__)))
    files = []
    for sub in ("models", "eval", "train"):
        for d, _, names in os.walk(os.path.join(pkg, sub)):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 8
    for path in files:
        assert _passes_tensor_cores(path) == [], path
    # the scan sees the keyword where it is passed, and fused_block's
    # launcher and plan take it
    assert _passes_tensor_cores(tfb.__file__)
    for fn in (tfb._launch, tfb.plan):
        assert "tensor_cores" in inspect.signature(fn).parameters
