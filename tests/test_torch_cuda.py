"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
tests directory's ``conftest.py`` imports JAX, which a GPU machine need
not have, so run this file on its own:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

The shapes are small and ragged (extents that are no multiple of the
kernels' tiles); ``chip_smoke.py`` holds the kernels at the main path's
full shapes.  fp32 runs with TF32 off and agrees to max-abs-err <=
1e-4 * max|y|; bf16 by cosine >= 0.999 and a norm ratio within 1%; the
pool is exact.  The bf16 forward and backward on the tensor cores are also
held against the bf16 CUDA-core instances, which multiply the same
operands.
"""

import pytest
import torch
import torch.nn.functional as F

from multimodal_fusion_fpn_torch.ops import fused_conv as tfc
from multimodal_fusion_fpn_torch.ops import pool as tpool

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU path")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _assert_close(y, ref, dtype):
    y, ref = y.double(), ref.double()
    assert torch.isfinite(y).all()
    if dtype == torch.float32:
        err, peak = (y - ref).abs().max().item(), ref.abs().max().item()
        assert err <= 1e-4 * peak, (err, peak)
    else:
        cos = F.cosine_similarity(y.flatten(), ref.flatten(), dim=0).item()
        ratio = (y.norm() / ref.norm()).item()
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (cos, ratio)


# (x shape, taps, z stride): 3D (1,3,3) and (3,1,1), 2D (1,3)/(3,1) as X=1,
# 1x1x1, stride-2 cascades with even and odd depth
CONV_CASES = [((2, 4, 16, 40, 16), (1, 3, 3), 1),
              ((2, 5, 13, 45, 32), (1, 3, 3), 1),
              ((2, 5, 13, 45, 16), (3, 1, 1), 1),
              ((1, 9, 1, 40, 16), (1, 1, 3), 1),
              ((1, 9, 1, 40, 64), (3, 1, 1), 1),
              ((2, 3, 5, 37, 24), (1, 1, 1), 1),
              ((2, 4, 8, 62, 32), (1, 1, 3), 2),
              ((2, 3, 7, 31, 64), (1, 1, 3), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("affine,relu", [(True, True), (False, False),
                                         (True, False)])
@pytest.mark.parametrize("shape,taps,stride_z", CONV_CASES)
def test_fused_conv_kernel_matches_plain(gen, shape, taps, stride_z,
                                         affine, relu, dtype):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    ci = shape[-1]
    x = rnd(*shape)
    s, b = (rnd(ci), rnd(ci)) if affine else (None, None)
    w = rnd(*taps, ci, 32) * 0.2
    name = "fused_conv_ky3" if taps[0] == 3 else "fused_conv"
    before = tfc.launches[name]
    y = tfc.fused_conv(x, s, b, w, relu, stride_z)
    torch.cuda.synchronize()
    assert tfc.launches[name] == before + 1
    ref = tfc.fused_conv_plain(x, s, b, w, relu, stride_z)
    assert y.shape == ref.shape and y.dtype == dtype
    _assert_close(y, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("window", [(1, 2, 2), (2, 2, 2), (1, 1, 2),
                                    (2, 1, 2)])
def test_max_pool_kernel_matches_plain(gen, window, dtype):
    x = torch.randn(2, 5, 9, 63, 16, generator=gen, device="cuda").to(dtype)
    before = tpool.launches["max_pool3d_cl"]
    y = tpool.max_pool3d_cl(x, window)
    torch.cuda.synchronize()
    assert tpool.launches["max_pool3d_cl"] == before + 1
    assert torch.equal(y, tpool.max_pool3d_cl_plain(x, window))


@pytest.mark.cuda
def test_fused_conv_kernel_refuses_what_it_does_not_take(gen):
    x = torch.randn(1, 2, 3, 8, 8, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="no kernel for taps"):
        tfc.fused_conv(x, None, None, torch.randn(3, 3, 3, 8, 16,
                                                  device="cuda"), False)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.fused_conv(x.transpose(1, 2), None, None,
                       torch.randn(1, 3, 3, 8, 16, device="cuda"), False)


# --- training: the stats epilogue, the backward kernels, the pool backward --

def _conv_args(gen, shape, taps, stride_z, affine, dtype, co=32):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    ci = shape[-1]
    x = rnd(*shape).to(dtype)
    s = (0.5 + rnd(ci).abs()).to(dtype) if affine else None
    b = (0.5 * rnd(ci)).to(dtype) if affine else None
    w = (rnd(*taps, ci, co) * 0.2).to(dtype)
    zo = (shape[3] - 1) // stride_z + 1
    g = rnd(*shape[:3], zo, co).to(dtype)
    return x, s, b, w, g, rnd(co), 0.01 * rnd(co)


# the conv cases the backward kernels take (ci % 16 == 0)
BWD_CASES = [c for c in CONV_CASES if c[0][-1] % 16 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,taps,stride_z", CONV_CASES)
def test_fused_conv_stats_kernel_matches_plain(gen, shape, taps, stride_z,
                                               dtype):
    """The stats epilogue: y as without it, (s1, s2) the fp32 sums of the
    kernel's rounded y, and two runs bitwise equal (no float atomics)."""
    x, s, b, w, _, _, _ = _conv_args(gen, shape, taps, stride_z, True, dtype)
    name = ("fused_conv_ky3" if taps[0] == 3 else "fused_conv") + "_stats"
    before = tfc.launches[name]
    y, s1, s2 = tfc.fused_conv(x, s, b, w, True, stride_z, with_stats=True)
    again = tfc.fused_conv(x, s, b, w, True, stride_z, with_stats=True)
    torch.cuda.synchronize()
    assert tfc.launches[name] == before + 2
    assert s1.dtype == s2.dtype == torch.float32
    assert torch.equal(y, tfc.fused_conv(x, s, b, w, True, stride_z))
    for a, c in zip((y, s1, s2), again):
        assert torch.equal(a, c)
    r1, r2 = tfc.channel_sums(y)
    _assert_close(s1, r1, torch.float32)
    _assert_close(s2, r2, torch.float32)
    ref = tfc.fused_conv_plain(x, s, b, w, True, stride_z, with_stats=True)
    for a, c in zip((y, s1, s2), ref):
        _assert_close(a, c, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("stats", [False, True], ids=["g", "g+stats"])
@pytest.mark.parametrize("affine,relu", [(True, True), (False, False),
                                         (True, False)])
@pytest.mark.parametrize("shape,taps,stride_z", BWD_CASES)
def test_fused_conv_bwd_kernels_match_plain(gen, shape, taps, stride_z,
                                            affine, relu, stats, dtype):
    """dx, ds, db (dgrad) and dw (wgrad) against the plain backward, with
    and without the stats cotangent; two runs bitwise equal."""
    x, s, b, w, g, gs1, gs2 = _conv_args(gen, shape, taps, stride_z, affine,
                                         dtype)
    cot = None
    if stats:
        y = tfc.fused_conv(x, s, b, w, relu, stride_z)
        cot = (y, gs1, gs2)
    k3 = "fused_conv_ky3" if taps[0] == 3 else "fused_conv"
    before = (tfc.launches[k3 + "_dgrad"], tfc.launches[k3 + "_wgrad"])
    got = tfc.fused_conv_bwd(x, s, b, w, g, relu, stride_z, cot)
    again = tfc.fused_conv_bwd(x, s, b, w, g, relu, stride_z, cot)
    torch.cuda.synchronize()
    assert (tfc.launches[k3 + "_dgrad"],
            tfc.launches[k3 + "_wgrad"]) == (before[0] + 2, before[1] + 2)
    ref = tfc.fused_conv_bwd_plain(x, s, b, w, g, relu, stride_z, cot)
    for name, a, c, r in zip(("dx", "ds", "db", "dw"), got, again, ref):
        if r is None:
            assert a is None, name
            continue
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.equal(a, c), name
        _assert_close(a, r, dtype if name in ("dx", "dw") else
                      torch.float32 if dtype == torch.float32 else dtype)


@pytest.mark.cuda
def test_fused_conv_autograd_launches_the_backward_kernels(gen):
    x, s, b, w, g, gs1, gs2 = _conv_args(gen, (1, 4, 8, 40, 16), (1, 3, 3),
                                         1, True, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (x, s, b, w)]
    before = dict(tfc.launches)
    y, s1, s2 = tfc.fused_conv(*leaves, True, with_stats=True)
    ((y * g).sum() + (s1 * gs1).sum() + (s2 * gs2).sum()).backward()
    torch.cuda.synchronize()
    for k in ("fused_conv_stats", "fused_conv_dgrad", "fused_conv_wgrad"):
        assert tfc.launches[k] == before[k] + 1, k
    ref = tfc.fused_conv_bwd_plain(x, s, b, w, g, True, 1,
                                   (y.detach(), gs1, gs2))
    for leaf, r in zip(leaves, ref):
        _assert_close(leaf.grad, r, torch.float32)


@pytest.mark.cuda
def test_fused_conv_bwd_refuses_what_it_does_not_take(gen):
    x, s, b, w, g, gs1, gs2 = _conv_args(gen, (1, 2, 3, 8, 8), (1, 3, 3), 1,
                                         True, torch.float32, co=16)
    with pytest.raises(ValueError, match="ci % 16"):
        tfc.fused_conv_bwd(x, s, b, w, g, True)
    with pytest.raises(ValueError, match="ci % 16"):
        tfc.fused_conv(x.requires_grad_(), s, b, w, True)
    x, s, b, w, g, gs1, gs2 = _conv_args(gen, (1, 2, 3, 8, 16), (1, 3, 3), 1,
                                         True, torch.float32, co=16)
    with pytest.raises(ValueError, match="g must be"):
        tfc.fused_conv_bwd(x, s, b, w, g[..., :4, :], True)
    with pytest.raises(ValueError, match="gs1 must be"):
        tfc.fused_conv_bwd(x, s, b, w, g, True, 1,
                           (g, gs1.to(torch.bfloat16), gs2))


# The bf16 backward on the tensor cores (``csrc/fused_conv_bwd_mma.cu``):
# (x shape, taps, z stride, co) at every tap set, ci != co, X = 1 and Y, X,
# Z no multiple of the tiles (8 rows, 32 z), the stride-2 cascade at even
# and odd Z
MMA_CASES = [((2, 5, 13, 45, 16), (1, 3, 3), 1, 16),
             ((2, 4, 16, 40, 16), (1, 3, 3), 1, 32),
             ((2, 4, 16, 40, 32), (1, 3, 3), 1, 64),
             ((1, 3, 8, 40, 64), (1, 3, 3), 1, 64),
             ((2, 5, 13, 45, 16), (3, 1, 1), 1, 16),
             ((1, 9, 1, 40, 64), (3, 1, 1), 1, 64),
             ((1, 9, 1, 40, 16), (1, 1, 3), 1, 32),
             ((2, 3, 5, 37, 32), (1, 1, 1), 1, 64),
             ((2, 4, 8, 62, 32), (1, 1, 3), 2, 32),
             ((2, 3, 7, 31, 64), (1, 1, 3), 2, 64)]
# (affine, relu, stats cotangent)
MMA_MODES = [(True, True, True), (True, True, False), (False, False, False),
             (False, True, True)]


def _assert_same_operands(got, ref, name):
    """The tensor-core result against the CUDA-core one, which multiplies
    the same bf16 operands and sums in another order: cosine >= 0.99999;
    y / dx / dw (bf16) within 2^-7 * max|ref|, ds / db (fp32) within 1e-4 *
    max|ref|, s1 / s2 at their tolerance against plain as well (norm ratio
    within 1%)."""
    got, ref = got.double(), ref.double()
    cos = F.cosine_similarity(got.flatten(), ref.flatten(), dim=0).item()
    err, peak = (got - ref).abs().max().item(), ref.abs().max().item()
    ratio = (got.norm() / ref.norm()).item()
    if name in ("s1", "s2"):
        ok = abs(ratio - 1) <= 0.01
    else:
        ok = err <= (2 ** -7 if name in ("y", "dx", "dw") else 1e-4) * peak
    assert cos >= 0.99999 and ok, (name, cos, err, peak, ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("affine,relu,stats", MMA_MODES,
                         ids=["affine_relu_stats", "affine_relu",
                              "identity", "relu_stats"])
@pytest.mark.parametrize("shape,taps,stride_z,co", MMA_CASES)
def test_bf16_bwd_tensor_cores_match_plain_and_cuda_cores(
        gen, shape, taps, stride_z, co, affine, relu, stats):
    """dgrad and wgrad in bf16 on the tensor cores: against the plain
    backward (bf16 tolerances), against the bf16 CUDA-core instance (the
    same operands), two runs bitwise equal; the public backward takes
    them, counted under the usual names."""
    bf = torch.bfloat16
    x, s, b, w, g, gs1, gs2 = _conv_args(gen, shape, taps, stride_z, affine,
                                         bf, co=co)
    cot = None
    if stats:
        cot = (tfc.fused_conv(x, s, b, w, relu, stride_z), gs1, gs2)
    args = (x, s, b, w, g, relu, stride_z, cot)
    k3 = "fused_conv_ky3" if taps[0] == 3 else "fused_conv"
    before = (tfc.launches[k3 + "_dgrad"], tfc.launches[k3 + "_wgrad"])
    public = tfc.fused_conv_bwd(*args)
    torch.cuda.synchronize()
    assert (tfc.launches[k3 + "_dgrad"],
            tfc.launches[k3 + "_wgrad"]) == (before[0] + 1, before[1] + 1)
    got = (*tfc._launch_dgrad(*args), tfc._launch_wgrad(*args))
    cores = (*tfc._launch_dgrad(*args, tensor_cores=False),
             tfc._launch_wgrad(*args, tensor_cores=False))
    ref = tfc.fused_conv_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, a, p, c, r in zip(("dx", "ds", "db", "dw"), got, public,
                                cores, ref):
        if r is None:
            assert a is None and c is None, name
            continue
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.equal(a, p), name
        _assert_close(a, r, bf)
        _assert_same_operands(a, c, name)


@pytest.mark.cuda
def test_fp32_bwd_keeps_the_cuda_cores(gen):
    """fp32 takes the CUDA-core kernels whatever ``tensor_cores`` says."""
    x, s, b, w, g, _, _ = _conv_args(gen, (1, 4, 8, 40, 16), (1, 3, 3), 1,
                                     True, torch.float32)
    args = (x, s, b, w, g, True, 1, None)
    for a, c in zip(tfc._launch_dgrad(*args),
                    tfc._launch_dgrad(*args, tensor_cores=False)):
        assert torch.equal(a, c)
    assert torch.equal(tfc._launch_wgrad(*args),
                       tfc._launch_wgrad(*args, tensor_cores=False))


# The bf16 forward on the tensor cores (``csrc/fused_conv_mma.cu``): (x
# shape, taps, z stride, co) at every tap set, ci != co (16 -> 32, 32 ->
# 64), ci = co = 64, co = 128 (two channel groups), ci = 8 and 24 (the
# zero-filled half of the last k16 chunk), ci = 80 (weights in chunks),
# X = 1, Y, X, Z no multiple of the tiles (8 rows, 32 z), the stride-2
# cascade at even and odd Z
FWD_MMA_CASES = [((2, 5, 13, 45, 16), (1, 3, 3), 1, 16),
                 ((2, 4, 16, 40, 16), (1, 3, 3), 1, 32),
                 ((2, 4, 16, 40, 32), (1, 3, 3), 1, 64),
                 ((1, 3, 8, 40, 64), (1, 3, 3), 1, 64),
                 ((1, 3, 9, 37, 64), (1, 3, 3), 1, 128),
                 ((2, 3, 7, 33, 8), (1, 3, 3), 1, 16),
                 ((1, 4, 6, 35, 24), (1, 3, 3), 1, 32),
                 ((2, 5, 13, 45, 16), (3, 1, 1), 1, 16),
                 ((1, 9, 1, 40, 64), (3, 1, 1), 1, 64),
                 ((1, 3, 5, 20, 80), (3, 1, 1), 1, 16),
                 ((1, 9, 1, 40, 16), (1, 1, 3), 1, 32),
                 ((2, 3, 5, 37, 32), (1, 1, 1), 1, 64),
                 ((2, 4, 8, 62, 32), (1, 1, 3), 2, 32),
                 ((2, 3, 7, 31, 64), (1, 1, 3), 2, 64)]
# (affine, relu, stats)
FWD_MMA_MODES = [(True, True, True), (True, True, False),
                 (False, False, False), (False, True, True),
                 (True, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("affine,relu,stats", FWD_MMA_MODES,
                         ids=["affine_relu_stats", "affine_relu", "identity",
                              "relu_stats", "affine"])
@pytest.mark.parametrize("shape,taps,stride_z,co", FWD_MMA_CASES)
def test_bf16_forward_tensor_cores_match_plain_and_cuda_cores(
        gen, shape, taps, stride_z, co, affine, relu, stats):
    """The bf16 forward (± stats) on the tensor cores: against the plain
    forward (bf16 tolerances), against the bf16 CUDA-core instance (the
    same operands), two runs bitwise equal; the public wrapper takes it,
    counted under the usual names; s1 / s2 are the sums of its own y."""
    bf = torch.bfloat16
    x, s, b, w, _, _, _ = _conv_args(gen, shape, taps, stride_z, affine, bf,
                                     co=co)
    name = ("fused_conv_ky3" if taps[0] == 3 else "fused_conv") + (
        "_stats" if stats else "")
    before = tfc.launches[name]
    got = tfc.fused_conv(x, s, b, w, relu, stride_z, with_stats=stats)
    again = tfc.fused_conv(x, s, b, w, relu, stride_z, with_stats=stats)
    cores = tfc._launch_forward(x, s, b, w, relu, stride_z, stats,
                                tensor_cores=False)
    torch.cuda.synchronize()
    assert tfc.launches[name] == before + 3
    ref = tfc.fused_conv_plain(x, s, b, w, relu, stride_z, with_stats=stats)
    if not stats:
        got, again, cores, ref = (got,), (again,), (cores,), (ref,)
    for out, a, c, k, r in zip(("y", "s1", "s2"), got, again, cores, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, out
        assert torch.equal(a, c), out
        _assert_close(a, r, bf)
        _assert_same_operands(a, k, out)
    if stats:
        for a, r in zip(got[1:], tfc.channel_sums(got[0])):
            _assert_close(a, r, torch.float32)


# (x shape, taps, z stride, co, true extents): random everywhere, so the
# padding beyond the extents holds garbage
FWD_MMA_DYN_CASES = [((2, 5, 13, 45, 16), (1, 3, 3), 1, 16, (4, 11, 38)),
                     ((1, 4, 9, 40, 64), (1, 3, 3), 1, 64, (3, 7, 33)),
                     ((2, 5, 13, 45, 32), (3, 1, 1), 1, 32, (3, 13, 45)),
                     ((1, 9, 1, 40, 16), (1, 1, 3), 1, 32, (7, 1, 29)),
                     ((2, 3, 5, 37, 24), (1, 1, 1), 1, 16, (3, 2, 20)),
                     ((2, 4, 8, 62, 32), (1, 1, 3), 2, 32, (4, 5, 49)),
                     ((2, 3, 7, 31, 64), (1, 1, 3), 2, 64, (1, 7, 30))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,taps,stride_z,co,ext", FWD_MMA_DYN_CASES)
def test_bf16_forward_extents_tensor_cores_match_plain_and_cuda_cores(
        gen, shape, taps, stride_z, co, ext):
    """K7 in bf16 on the tensor cores: against the masked plain forward,
    against the bf16 CUDA-core instance, bitwise repeatable; the garbage
    beyond the extents shows in the unmasked plain forward."""
    bf = torch.bfloat16
    x, s, b, w, _, _, _ = _conv_args(gen, shape, taps, stride_z, True, bf,
                                     co=co)
    name = "fused_conv_dyn_ky3" if taps[0] == 3 else "fused_conv_dyn"
    before = tfc.launches[name]
    got = tfc.fused_conv(x, s, b, w, True, stride_z, dyn_extents=ext)
    again = tfc.fused_conv(x, s, b, w, True, stride_z, dyn_extents=ext)
    cores = tfc._launch_forward(x, s, b, w, True, stride_z, False, ext,
                                tensor_cores=False)
    torch.cuda.synchronize()
    assert tfc.launches[name] == before + 3
    ref = tfc.fused_conv_dyn_plain(x, s, b, w, True, stride_z, ext)
    assert got.shape == ref.shape and got.dtype == bf
    assert torch.equal(got, again)
    _assert_close(got, ref, bf)
    _assert_same_operands(got, cores, "y")
    unmasked = tfc.fused_conv_plain(x, s, b, w, True, stride_z)
    assert not torch.equal(unmasked, ref)
    whole = tuple(shape[1:4])
    assert torch.equal(tfc.fused_conv(x, s, b, w, True, stride_z,
                                      dyn_extents=whole),
                       tfc.fused_conv(x, s, b, w, True, stride_z))


@pytest.mark.cuda
def test_fp32_forward_keeps_the_cuda_cores(gen):
    """fp32 takes the CUDA-core forward whatever ``tensor_cores`` says."""
    x, s, b, w, _, _, _ = _conv_args(gen, (1, 4, 8, 40, 16), (1, 3, 3), 1,
                                     True, torch.float32)
    for stats in (False, True):
        got = tfc._launch_forward(x, s, b, w, True, 1, stats)
        cores = tfc._launch_forward(x, s, b, w, True, 1, stats,
                                    tensor_cores=False)
        for a, c in zip(got if stats else (got,), cores if stats else (cores,)):
            assert torch.equal(a, c)


def _tied(gen, shape, dtype):
    """Values on a coarse grid, so windows hold exact ties, with +0 and -0
    both present."""
    v = torch.randint(-2, 3, shape, generator=gen, device="cuda").float()
    v = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5,
                    v, -v)
    return v.to(dtype)


# (x shape, window): the floor leaves a remainder on every axis; C = 8, 24
# and 72 take the 8-channel vector lanes, C = 12 the scalar lanes
POOL_BWD_CASES = [((2, 5, 9, 63, 16), (1, 2, 2)),
                  ((2, 5, 9, 63, 16), (2, 2, 2)),
                  ((2, 5, 9, 63, 16), (1, 1, 2)),
                  ((2, 5, 9, 63, 16), (2, 1, 2)),
                  ((1, 7, 5, 31, 8), (2, 2, 2)),
                  ((2, 3, 7, 29, 24), (2, 2, 2)),
                  ((1, 5, 3, 17, 72), (2, 2, 2)),
                  ((1, 7, 5, 33, 12), (2, 2, 2)),
                  ((2, 4, 6, 9, 24), (3, 4, 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,window", POOL_BWD_CASES)
def test_max_pool_bwd_kernel_matches_plain_on_ties(gen, shape, window, dtype):
    """K5b: g to every tied max (+0 == -0, both present in the input), 0
    beyond the floor-sized region; exact.  The autograd Function launches
    it."""
    x = _tied(gen, shape, dtype)
    assert (x == 0).any() and torch.signbit(x[x == 0]).any()
    assert not torch.signbit(x[x == 0]).all()
    y = tpool.max_pool3d_cl(x, window)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    before = tpool.launches["max_pool3d_cl_bwd"]
    dx = tpool.max_pool3d_cl_bwd(x, y, g, window)
    xg = x.clone().requires_grad_()
    tpool.max_pool3d_cl(xg, window).backward(g)
    torch.cuda.synchronize()
    assert tpool.launches["max_pool3d_cl_bwd"] == before + 2
    ref = tpool.max_pool3d_cl_bwd_plain(x, y, g, window)
    assert torch.equal(dx, ref) and torch.equal(xg.grad, ref)
    # ties really occur: some window gives its g to more than one element
    assert (dx != 0).sum() > (g != 0).sum()


@pytest.mark.cuda
def test_max_pool_first_max_backward_matches_torch(gen):
    """The stage-4 rule, JAX's select-and-scatter (``ge`` select): g to
    the first max in (Y, X, Z) order, and to a NaN only when no later
    element of its window follows it.  The autograd Function on the card
    against the same plain function on the CPU (which
    ``tests/test_torch_ops.py`` holds against JAX), and against
    F.max_pool3d's backward on the windows without a NaN."""
    x = _tied(gen, (2, 4, 6, 16, 128), torch.float32)
    x[0, 0, 0, 0, 0] = x[0, 1, 0, 2, 1] = x[1, 1, 1, 15, 2] = float("nan")
    g = torch.randn(2, 2, 3, 8, 128, generator=gen, device="cuda")
    xg = x.clone().requires_grad_()
    tpool.max_pool3d_cl(xg, (2, 2, 2), first_max=True).backward(g)
    want = tpool.max_pool3d_cl_bwd_first(x.cpu(), g.cpu(), (2, 2, 2))
    assert torch.equal(xg.grad.cpu(), want)
    assert xg.grad[0, 0, 0, 0, 0] == 0 and xg.grad[1, 1, 1, 15, 2] != 0
    xt = x.permute(0, 4, 1, 2, 3).clone().requires_grad_()
    F.max_pool3d(xt, (2, 2, 2)).backward(g.permute(0, 4, 1, 2, 3))
    clean = ~x.isnan().reshape(2, 2, 2, 3, 2, 8, 2, 128).any(
        dim=(2, 4, 6), keepdim=True).expand(2, 2, 2, 3, 2, 8, 2,
                                            128).reshape(x.shape)
    assert torch.equal(xg.grad[clean],
                       xt.grad.permute(0, 2, 3, 4, 1)[clean])


_INTS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _same_bits(a, b):
    """NaN at the same places (``equal_nan``), the same bits elsewhere."""
    na, nb = a.isnan(), b.isnan()
    return bool(torch.equal(na, nb)) and torch.equal(
        a.masked_fill(na, 0).view(_INTS[a.dtype]),
        b.masked_fill(nb, 0).view(_INTS[b.dtype]))


def _at_offset(x, offset):
    """x copied into a buffer ``offset`` elements in (a storage offset that
    is not 16-byte aligned for offset 1)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    v = buf[offset:].view(x.shape)
    v.copy_(x)
    return v


def _planted(gen, shape, window, dtype, offset):
    """randn with NaN at the first position of two windows and at the last
    position of two others, and +inf and -inf elsewhere."""
    x = torch.randn(shape, generator=gen, device="cuda")
    B, Y, X, Z, C = shape
    wy, wx, wz = window
    Yo, Xo, Zo = Y // wy, X // wx, Z // wz
    nan, inf = float("nan"), float("inf")
    x[0, 0, 0, 0, 0] = nan                                   # first, window 0
    x[B - 1, 0, 0, (Zo - 1) * wz, C - 1] = nan               # first
    x[0, wy - 1, wx - 1, wz - 1, C // 2] = nan               # last, window 0
    x[B - 1, Yo * wy - 1, Xo * wx - 1, Zo * wz - 1, C - 1] = nan  # last
    x[0, 0, 0, wz * (Zo // 2), 1] = inf
    x[B - 1, Yo * wy - 1, 0, 0, 2] = -inf
    return _at_offset(x.to(dtype), offset)


# (x shape, window, storage offset in elements): every main-path window at
# sizes the windows do not divide (floor remainders on every axis), C = 12
# (the scalar lanes), storage offsets that are not 16-byte aligned (the
# scalar lanes) and a window with no compiled instance
POOL_NAN_CASES = [((2, 5, 9, 63, 16), (1, 2, 2), 0),
                  ((2, 5, 9, 63, 16), (2, 2, 2), 0),
                  ((2, 5, 1, 63, 16), (1, 1, 2), 0),
                  ((2, 5, 1, 63, 16), (2, 1, 2), 0),
                  ((1, 7, 5, 33, 12), (2, 2, 2), 0),
                  ((2, 5, 9, 63, 16), (1, 2, 2), 1),
                  ((1, 5, 3, 17, 72), (2, 2, 2), 1),
                  ((2, 4, 6, 9, 24), (3, 4, 4), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,window,offset", POOL_NAN_CASES)
def test_max_pool_kernels_keep_nan_and_inf(gen, shape, window, offset,
                                           dtype):
    """K5f: NaN wherever a window holds one (as jnp.maximum and amax give
    it), the plain version's bits elsewhere, +-inf kept; K5b on that
    output: the plain version's bits, so every NaN input of a NaN window
    takes the window's g."""
    x = _planted(gen, shape, window, dtype, offset)
    before = tpool.launches["max_pool3d_cl"]
    y = tpool.max_pool3d_cl(x, window)
    torch.cuda.synchronize()
    assert tpool.launches["max_pool3d_cl"] == before + 1
    ref = tpool.max_pool3d_cl_plain(x, window)
    assert y.isnan().sum() >= 3 and y.isinf().any()
    assert _same_bits(y, ref)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    dx = tpool.max_pool3d_cl_bwd(x, y, g, window)
    assert _same_bits(dx, tpool.max_pool3d_cl_bwd_plain(x, y, g, window))
    B, Yo, Xo, Zo, C = y.shape
    wy, wx, wz = window
    gx = g[:, :, None, :, None, :, None].expand(
        B, Yo, wy, Xo, wx, Zo, wz, C).reshape(B, Yo * wy, Xo * wx, Zo * wz, C)
    region = dx[:, :Yo * wy, :Xo * wx, :Zo * wz]
    nan = x[:, :Yo * wy, :Xo * wx, :Zo * wz].isnan()
    assert nan.sum() >= 4 and torch.equal(region[nan], gx[nan])


# --- eval under exact shape bucketing: the extents instance (K7) -----------

# (x shape, taps, z stride, true extents (yt, xt, zt)); the input is random
# everywhere, so the padding beyond the extents holds garbage
DYN_CASES = [((2, 5, 13, 45, 16), (1, 3, 3), 1, (4, 11, 38)),
             ((2, 5, 13, 45, 32), (3, 1, 1), 1, (3, 13, 45)),
             ((1, 9, 1, 40, 16), (1, 1, 3), 1, (7, 1, 29)),
             ((2, 3, 5, 37, 24), (1, 1, 1), 1, (3, 2, 20)),
             ((2, 4, 8, 62, 32), (1, 1, 3), 2, (4, 5, 49)),
             ((2, 3, 7, 31, 64), (1, 1, 3), 2, (1, 7, 30))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,taps,stride_z,ext", DYN_CASES)
def test_fused_conv_dyn_kernel_matches_plain(gen, shape, taps, stride_z, ext,
                                             dtype):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    ci = shape[-1]
    x, s, b = rnd(*shape), rnd(ci), rnd(ci)
    w = rnd(*taps, ci, 32) * 0.2
    name = "fused_conv_dyn_ky3" if taps[0] == 3 else "fused_conv_dyn"
    before = dict(tfc.launches)
    y = tfc.fused_conv(x, s, b, w, True, stride_z, dyn_extents=ext)
    torch.cuda.synchronize()
    assert tfc.launches[name] == before[name] + 1
    assert sum(tfc.launches.values()) == sum(before.values()) + 1
    ref = tfc.fused_conv_dyn_plain(x, s, b, w, True, stride_z, ext)
    assert y.shape == ref.shape and y.dtype == dtype
    _assert_close(y, ref, dtype)
    # the garbage beyond the extents reaches the unmasked conv
    unmasked = tfc.fused_conv_plain(x, s, b, w, True, stride_z)
    assert not torch.equal(unmasked, ref)


@pytest.mark.cuda
def test_fused_conv_dyn_whole_extents_equal_the_plain_instance(gen):
    """Extents covering the whole input give K1's output bit for bit."""
    x = torch.randn(2, 5, 13, 45, 16, generator=gen, device="cuda")
    s, b = torch.randn(16, device="cuda"), torch.randn(16, device="cuda")
    w = torch.randn(1, 3, 3, 16, 32, device="cuda") * 0.2
    assert torch.equal(tfc.fused_conv(x, s, b, w, True,
                                      dyn_extents=(5, 13, 45)),
                       tfc.fused_conv(x, s, b, w, True))


@pytest.mark.cuda
def test_bucketed_model_on_the_card_matches_unpadded(gen):
    """FPNHybridFusion at the ini widths, fp32: the kernel path on a
    zero-padded batch with extents, cropped, against the kernel path on
    the unpadded batch, with every fused conv an extents instance."""
    from types import SimpleNamespace
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)
    model = build_model(cfg)
    image = torch.randn(1, 1, 12, 72, 48, generator=gen, device="cuda")
    slo = torch.randn(1, 1, 88, 1, 48, generator=gen, device="cuda")
    padded = {"image": F.pad(image, (0, 16, 0, 8, 0, 4)),
              "slo": F.pad(slo, (0, 16, 0, 0, 0, 8)),
              "__valid_image__": (12, 72, 48), "__valid_enface__": (88, 48)}
    with torch.inference_mode():
        ref = model({"image": image, "slo": slo})["prediction"]
        ops.reset_launches()
        got = model(padded)["prediction"]
        torch.cuda.synchronize()
    launches = ops.kernel_launches()
    assert launches["fused_conv_dyn"] > 0 and launches["fused_conv_dyn_ky3"]
    assert launches["fused_conv"] == launches["fused_conv_ky3"] == 0
    assert got.shape == (1, 1, 16, 1, 64)
    _assert_close(got[:, :, :12, :, :48], ref, torch.float32)


# --- eval block fusion: the chain and the pair (K8) --------------------------

# (x shape, convs, co, final, true extents or None); Y no multiple of the
# kernel's row chunk, X and Z no multiples of its tile, ci 8 to 64; the
# input is random everywhere, so with extents the padding holds garbage
CHAIN_CASES = [((2, 5, 13, 45, 16), 3, 16, "res_id", None),
               ((1, 7, 11, 70, 32), 3, 32, "res_id", (5, 9, 61)),
               ((2, 4, 9, 37, 16), 2, 32, "res_conv", None),
               ((1, 6, 6, 33, 32), 2, 64, "res_conv", (5, 4, 30)),
               ((1, 5, 5, 40, 64), 3, 64, "relu", None),
               ((2, 9, 3, 50, 64), 3, 64, "res_id", (7, 2, 44)),
               ((1, 3, 7, 35, 8), 2, 16, "affine", (2, 6, 31)),
               ((1, 6, 10, 37, 8), 3, 16, "res_conv", (6, 7, 36))]
# (x shape, co, entry affine + relu0, extents)
PAIR_CASES = [((2, 5, 13, 45, 16), 16, False, None),
              ((1, 6, 10, 37, 32), 32, True, (4, 7, 30)),
              ((1, 4, 5, 33, 8), 16, True, None),
              ((1, 3, 9, 66, 64), 64, False, (3, 8, 60))]


def _chain_args(gen, dtype, shape, n_conv, co, final):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    ci = shape[-1]
    affine = lambda: (1 + 0.2 * rnd(co), 0.2 * rnd(co))
    taps = [(1, 3, 3), (1, 3, 3), (3, 1, 1)][:n_conv]
    convs, c = [], ci
    for k in taps:
        convs.append((rnd(*k, c, co) / (9 * c) ** 0.5, *affine()))
        c = co
    s_in = b_in = None
    if final == "affine":
        s_in, b_in = 1 + 0.2 * rnd(ci), 0.2 * rnd(ci)
    ds = (rnd(1, 1, 1, ci, co) / ci ** 0.5, *affine()) \
        if final == "res_conv" else None
    return rnd(*shape), s_in, b_in, final == "affine", convs, final, ds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,n_conv,co,final,ext", CHAIN_CASES)
def test_fused_chain_kernel_matches_plain(gen, shape, n_conv, co, final,
                                          ext, dtype):
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    args = _chain_args(gen, dtype, shape, n_conv, co, final)
    name = "fused_chain_dyn" if ext else "fused_chain"
    before = dict(tfb.launches)
    y = tfb.fused_chain(*args, dyn_extents=ext)
    torch.cuda.synchronize()
    assert tfb.launches[name] == before[name] + 1
    assert sum(tfb.launches.values()) == sum(before.values()) + 1
    ref = tfb.fused_chain_plain(*args, dyn_extents=ext)
    assert y.shape == ref.shape == shape[:4] + (co,) and y.dtype == dtype
    _assert_close(y, ref, dtype)
    assert torch.equal(y, tfb.fused_chain(*args, dyn_extents=ext))
    if ext is not None:
        assert not y[:, ext[0]:].any() and not y[:, :, ext[1]:].any()
        assert not y[:, :, :, ext[2]:].any()
        # the garbage beyond the extents reaches the unmasked chain
        assert not torch.equal(tfb.fused_chain_plain(*args), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,co,entry,ext", PAIR_CASES)
def test_fused_pair_kernel_matches_plain(gen, shape, co, entry, ext, dtype):
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    ci = shape[-1]
    s0, b0 = (1 + 0.2 * rnd(ci), 0.2 * rnd(ci)) if entry else (None, None)
    args = (rnd(*shape), s0, b0, rnd(1, 3, 3, ci, co) / (9 * ci) ** 0.5,
            1 + 0.2 * rnd(co), 0.2 * rnd(co),
            rnd(1, 3, 3, co, co) / (9 * co) ** 0.5, entry)
    name = "fused_pair_dyn" if ext else "fused_pair"
    before = tfb.launches[name]
    y = tfb.fused_pair(*args, dyn_extents=ext)
    torch.cuda.synchronize()
    assert tfb.launches[name] == before + 1
    ref = tfb.fused_pair_plain(*args, dyn_extents=ext)
    assert y.shape == ref.shape == shape[:4] + (co,) and y.dtype == dtype
    _assert_close(y, ref, dtype)
    assert torch.equal(y, tfb.fused_pair(*args, dyn_extents=ext))


@pytest.mark.cuda
def test_fused_block_wrappers_refuse_what_they_do_not_take(gen):
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    x, s_in, b_in, relu0, convs, final, ds = _chain_args(
        gen, torch.float32, (1, 4, 5, 33, 16), 3, 16, "res_id")
    w0 = convs[0][0].clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        tfb.fused_chain(x, None, None, False, [(w0,) + convs[0][1:]]
                        + convs[1:], "res_id")
    with pytest.raises(ValueError, match="requires grad"):
        tfb.fused_pair(x, None, None, w0, *convs[0][1:], convs[1][0], False)
    with pytest.raises(ValueError, match="no kernel for"):
        tfb.fused_chain(x, None, None, False, convs[::-1], "res_id")
    x12 = torch.randn(1, 4, 5, 33, 12, device="cuda")
    w12 = [(torch.randn(1, 3, 3, 12, 16, device="cuda"),) + convs[0][1:]]
    with pytest.raises(ValueError, match="ci % 8"):
        tfb.fused_chain(x12, None, None, False, w12 + convs[1:2], "relu")
    with pytest.raises(ValueError, match="res_id needs"):
        tfb.fused_chain(torch.randn(1, 4, 5, 33, 8, device="cuda"), None,
                        None, False, [(torch.randn(1, 3, 3, 8, 16,
                                                   device="cuda"),)
                                      + convs[0][1:]] + convs[1:], "res_id")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chain", "pair"])
def test_block_fusion_model_on_the_card_matches_per_conv(gen, mode):
    """FPNHybridFusion at the ini widths, fp32, small input: the fused
    blocks against the per-conv kernel path, with 5 fused launches per
    forward (3D stage 1's second block, both blocks of stages 2 and 3)."""
    from types import SimpleNamespace
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)
    model = build_model(cfg)
    batch = {"image": torch.randn(1, 1, 12, 72, 48, generator=gen,
                                  device="cuda"),
             "slo": torch.randn(1, 1, 88, 1, 48, generator=gen,
                                device="cuda")}
    with torch.inference_mode():
        ref = model(batch)["prediction"]
        ops.reset_launches()
        got = model(batch, block_fusion=mode)["prediction"]
        torch.cuda.synchronize()
    launches = ops.kernel_launches()
    assert launches[f"fused_{mode}"] == 5
    assert (launches["fused_conv"], launches["fused_conv_ky3"]) == (
        (23, 3) if mode == "chain" else (25, 6))
    err = (got.double() - ref.double()).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


# The bf16 K8 on the tensor cores (``csrc/fused_block_mma.cu``): every
# CHAIN_CASES and PAIR_CASES entry, plus a model-like stage-1 chain at
# ragged Y, X, Z (16 channels, several windows along x and z), a 64-channel
# chain of several windows and y chunks (weights streamed through two k16
# slots), ci = 24 with the entry affine (the zero-filled half of the last
# k16 chunk), and two 64-channel convs from ci = 80, whose weights do not
# fit resident (streamed with two convs)
TC_CHAIN_CASES = CHAIN_CASES + [
    ((1, 13, 21, 99, 16), 3, 16, "res_id", None),
    ((1, 13, 21, 99, 16), 3, 16, "res_id", (11, 18, 90)),
    ((2, 11, 19, 75, 64), 3, 64, "res_id", None),
    ((1, 6, 11, 70, 24), 2, 32, "affine", None),
    ((1, 5, 9, 41, 24), 3, 32, "affine", (4, 8, 37)),
    ((1, 5, 9, 40, 80), 2, 64, "relu", None)]


def _pair_args(gen, dtype, shape, co, entry):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    ci = shape[-1]
    s0, b0 = (1 + 0.2 * rnd(ci), 0.2 * rnd(ci)) if entry else (None, None)
    return (rnd(*shape), s0, b0, rnd(1, 3, 3, ci, co) / (9 * ci) ** 0.5,
            1 + 0.2 * rnd(co), 0.2 * rnd(co),
            rnd(1, 3, 3, co, co) / (9 * co) ** 0.5, entry)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_conv,co,final,ext", TC_CHAIN_CASES)
def test_bf16_chain_tensor_cores_bit_equal_to_per_conv(gen, shape, n_conv,
                                                       co, final, ext):
    """The bf16 chain on the tensor cores: bitwise equal to the
    tensor-core per-conv path (the model's without block fusion), against
    plain at the bf16 tolerance, bitwise repeatable, one launch each; with
    extents 0 at and beyond them."""
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    args = _chain_args(gen, torch.bfloat16, shape, n_conv, co, final)
    name = "fused_chain_dyn" if ext else "fused_chain"
    before = dict(tfb.launches)
    y = tfb.fused_chain(*args, dyn_extents=ext)
    again = tfb.fused_chain(*args, dyn_extents=ext)
    torch.cuda.synchronize()
    assert tfb.launches[name] == before[name] + 2
    assert sum(tfb.launches.values()) == sum(before.values()) + 2
    assert y.shape == shape[:4] + (co,) and y.dtype == torch.bfloat16
    assert torch.equal(y, again)
    assert torch.equal(y, tfb.fused_chain_per_conv(*args, dyn_extents=ext))
    _assert_close(y, tfb.fused_chain_plain(*args, dyn_extents=ext),
                  torch.bfloat16)
    if ext is not None:
        assert not y[:, ext[0]:].any() and not y[:, :, ext[1]:].any()
        assert not y[:, :, :, ext[2]:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co,entry,ext", PAIR_CASES)
def test_bf16_pair_tensor_cores_bit_equal_to_per_conv(gen, shape, co, entry,
                                                      ext):
    """The bf16 pair on the tensor cores: bitwise equal to the
    tensor-core per-conv path, against plain, bitwise repeatable."""
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    args = _pair_args(gen, torch.bfloat16, shape, co, entry)
    name = "fused_pair_dyn" if ext else "fused_pair"
    before = tfb.launches[name]
    y = tfb.fused_pair(*args, dyn_extents=ext)
    again = tfb.fused_pair(*args, dyn_extents=ext)
    torch.cuda.synchronize()
    assert tfb.launches[name] == before + 2
    assert torch.equal(y, again)
    assert torch.equal(y, tfb.fused_pair_per_conv(*args, dyn_extents=ext))
    _assert_close(y, tfb.fused_pair_plain(*args, dyn_extents=ext),
                  torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_conv,co,final,ext", CHAIN_CASES)
def test_bf16_chain_cuda_cores_bit_equal_to_per_conv_cuda_cores(
        gen, shape, n_conv, co, final, ext):
    """The bf16 CUDA-core K8 instance (``_launch(..., tensor_cores=False)``,
    ``csrc/fused_block.cu``) stays bitwise equal to the CUDA-core per-conv
    path."""
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    x, s_in, b_in, relu0, convs, final, ds = _chain_args(
        gen, torch.bfloat16, shape, n_conv, co, final)
    tfb._check("fused_chain", x, s_in, b_in, convs, final, ds)
    y = tfb._launch("fused_chain", x, s_in, b_in, relu0, convs, final, ds,
                    ext, tensor_cores=False)
    ref = tfb.fused_chain_per_conv(x, s_in, b_in, relu0, convs, final, ds,
                                   dyn_extents=ext, tensor_cores=False)
    assert torch.equal(y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_conv,co,final,ext", CHAIN_CASES[:4])
def test_fp32_block_keeps_the_cuda_cores(gen, shape, n_conv, co, final, ext):
    """fp32 K8 takes ``csrc/fused_block.cu`` whatever ``tensor_cores``
    says, bitwise equal to the fp32 per-conv path."""
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    x, s_in, b_in, relu0, convs, final, ds = _chain_args(
        gen, torch.float32, shape, n_conv, co, final)
    y = tfb.fused_chain(x, s_in, b_in, relu0, convs, final, ds,
                        dyn_extents=ext)
    cores = tfb._launch("fused_chain", x, s_in, b_in, relu0, convs, final,
                        ds, ext, tensor_cores=False)
    assert torch.equal(y, cores)
    assert torch.equal(y, tfb.fused_chain_per_conv(
        x, s_in, b_in, relu0, convs, final, ds, dyn_extents=ext))
    assert tfb.plan(x, n_conv, co, final)[4] == 32


@pytest.mark.cuda
def test_bf16_block_refuses_channels_it_does_not_take(gen):
    """co outside (16, 32, 64) raises in bf16 (fp32 takes it)."""
    from multimodal_fusion_fpn_torch.ops import fused_block as tfb
    for dtype, raises in ((torch.bfloat16, True), (torch.float32, False)):
        x, s_in, b_in, relu0, convs, final, ds = _chain_args(
            gen, dtype, (1, 3, 5, 33, 16), 2, 48, "relu")
        if raises:
            with pytest.raises(ValueError, match="co in"):
                tfb.fused_chain(x, s_in, b_in, relu0, convs, final, ds)
        else:
            tfb.fused_chain(x, s_in, b_in, relu0, convs, final, ds)


# --- the narrow-entry conv (K10) ---------------------------------------------

# (x shape, taps, co): the 3D and 2D entry convs and the 1x1x1 downsample
# (ci 1 -> co 16) at ragged shapes, the data gradient's instance (ci 16 ->
# co 1), a ci no multiple of 8, and ci = co = 64 with 27 taps (the weights
# then go through shared memory in chunks of taps)
BANDED_CASES = [((2, 5, 13, 45, 1), (1, 3, 3), 16),
                ((1, 9, 1, 40, 1), (1, 1, 3), 16),
                ((2, 3, 5, 37, 1), (1, 1, 1), 16),
                ((2, 5, 13, 45, 16), (1, 3, 3), 1),
                ((1, 4, 7, 33, 3), (3, 1, 3), 32),
                ((1, 3, 5, 20, 64), (3, 3, 3), 64)]


def _banded_args(gen, shape, taps, co, dtype):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = rnd(*shape).to(dtype)
    w = (rnd(*taps, shape[-1], co) / (shape[-1] * 9) ** 0.5).to(dtype)
    g = rnd(*shape[:4], co).to(dtype)
    return x, w, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,taps,co", BANDED_CASES)
def test_banded_conv_kernel_matches_plain(gen, shape, taps, co, dtype):
    from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
    x, w, g = _banded_args(gen, shape, taps, co, dtype)
    before = dict(tbc.launches)
    y = tbc.banded_conv(x, w)
    torch.cuda.synchronize()
    assert tbc.launches["banded_conv"] == before["banded_conv"] + 1
    ref = tbc.banded_conv_plain(x, w)
    assert y.shape == ref.shape and y.dtype == dtype
    _assert_close(y, ref, dtype)
    # the weight gradient: against plain, and bitwise repeatable
    dw = tbc.banded_conv_wgrad(x, g, w.shape)
    assert dw.dtype == dtype and dw.shape == w.shape
    _assert_close(dw, tbc.banded_conv_wgrad_plain(x, g, w.shape), dtype)
    assert torch.equal(dw, tbc.banded_conv_wgrad(x, g, w.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,taps,co,ext", [
    ((2, 5, 13, 45, 1), (1, 3, 3), 16, (4, 9, 31)),
    ((1, 9, 1, 40, 1), (1, 1, 3), 16, (7, 1, 29)),
    ((2, 3, 5, 37, 1), (1, 1, 1), 16, (3, 4, 36))])
def test_banded_conv_extents_kernel_matches_plain(gen, shape, taps, co, ext,
                                                  dtype):
    """x random everywhere: the garbage beyond the extents reaches the
    unmasked conv and not the kernel."""
    from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
    x, w, g = _banded_args(gen, shape, taps, co, dtype)
    before = tbc.launches["banded_conv_dyn"]
    y = tbc.banded_conv(x, w, dyn_extents=ext)
    torch.cuda.synchronize()
    assert tbc.launches["banded_conv_dyn"] == before + 1
    ref = tbc.banded_conv_plain(x, w, ext)
    _assert_close(y, ref, dtype)
    assert not torch.equal(tbc.banded_conv_plain(x, w), ref)
    whole = tuple(shape[1:4])
    assert torch.equal(tbc.banded_conv(x, w, dyn_extents=whole),
                       tbc.banded_conv(x, w))
    _assert_close(tbc.banded_conv_wgrad(x, g, w.shape, ext),
                  tbc.banded_conv_wgrad_plain(x, g, w.shape, ext), dtype)


# (x shape, taps, extents, storage offset): Z above the entry kernel's z
# tile (1024) and no multiple of it, Z no multiple of 8 (scalar staging),
# extents that end inside a tile, the X = 1 view of the 2D stage, both tap
# sets of the 3D stage, and an x that is not 16-byte aligned
ENTRY_CASES = [((1, 2, 3, 1100, 1), (1, 3, 3), None, 0),
               ((1, 2, 3, 1096, 1), (1, 1, 1), (2, 2, 1090), 0),
               ((2, 5, 13, 45, 1), (1, 3, 3), None, 0),
               ((2, 5, 13, 48, 1), (1, 3, 3), (4, 9, 31), 0),
               ((2, 5, 13, 48, 1), (1, 1, 1), (5, 11, 44), 0),
               ((1, 40, 1, 128, 1), (1, 1, 3), (37, 1, 101), 0),
               ((1, 40, 1, 128, 1), (1, 1, 1), None, 0),
               ((2, 5, 13, 48, 1), (1, 3, 3), None, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,taps,ext,offset", ENTRY_CASES)
def test_banded_conv_entry_kernel_matches_generic_and_plain(
        gen, shape, taps, ext, offset, dtype):
    """K10's entry kernel (ci = 1 -> co = 16): the generic forward kernel's
    bits (the same fp32 sum in the same tap order), the plain version
    within the tolerance, and two runs bitwise equal."""
    from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
    x, w, _ = _banded_args(gen, shape, taps, 16, dtype)
    x = _at_offset(x, offset)
    name = "banded_conv" if ext is None else "banded_conv_dyn"
    before = tbc.launches[name]
    y = tbc.banded_conv(x, w, dyn_extents=ext)
    torch.cuda.synchronize()
    assert tbc.launches[name] == before + 1
    assert _same_bits(y, tbc._run(x, w, ext, "mmf_banded_conv_generic"))
    _assert_close(y, tbc.banded_conv_plain(x, w, ext), dtype)
    assert torch.equal(y, tbc.banded_conv(x, w, dyn_extents=ext))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_banded_conv_autograd_launches_its_kernels(gen, dtype):
    """``BandedConv``: dw through the weight-gradient kernel, dx (only when
    x needs it) through the forward kernel on the flipped weights."""
    from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
    x, w, g = _banded_args(gen, (2, 5, 13, 45, 1), (1, 3, 3), 16, dtype)
    for x_grad in (False, True):
        xg = x.clone().requires_grad_(x_grad)
        wg = w.clone().requires_grad_()
        before = dict(tbc.launches)
        tbc.banded_conv(xg, wg).backward(g)
        torch.cuda.synchronize()
        grew = {k: tbc.launches[k] - before[k] for k in before}
        assert grew == {"banded_conv": 1, "banded_conv_dyn": 0,
                        "banded_conv_wgrad": 1,
                        "banded_conv_dgrad": int(x_grad)}
        _assert_close(wg.grad, tbc.banded_conv_wgrad_plain(x, g, w.shape),
                      dtype)
        if x_grad:
            _assert_close(xg.grad, tbc.banded_conv_dgrad_plain(g, w), dtype)
        else:
            assert xg.grad is None


@pytest.mark.cuda
def test_banded_conv_never_takes_the_plain_version_on_the_card(
        gen, monkeypatch):
    from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
    x, w, g = _banded_args(gen, (1, 2, 3, 16, 1), (1, 3, 3), 16,
                           torch.float32)
    with pytest.raises(ValueError, match="co in"):
        tbc.banded_conv(x, w[..., :8].contiguous())
    with pytest.raises(ValueError, match="taps"):
        tbc.banded_conv(x, torch.zeros(1, 5, 3, 1, 16, device="cuda"))
    with pytest.raises(ValueError, match="co in"):   # dx's kernel: co 16
        tbc.banded_conv(torch.zeros(1, 2, 3, 16, 2, device="cuda",
                                    requires_grad=True),
                        torch.zeros(1, 3, 3, 2, 16, device="cuda"))

    def failed_build(*args):
        raise RuntimeError("kernel build failed")
    for name in ("banded_conv_plain", "banded_conv_wgrad_plain",
                 "banded_conv_dgrad_plain"):
        monkeypatch.setattr(tbc, name, None)
    monkeypatch.setattr(tbc, "_fn", failed_build)
    for call in (lambda: tbc.banded_conv(x, w),
                 lambda: tbc.banded_conv(x, w, dyn_extents=(1, 2, 9)),
                 lambda: tbc.banded_conv_wgrad(x, g, w.shape),
                 lambda: tbc.banded_conv_dgrad(g, w)):
        with pytest.raises(RuntimeError, match="build failed"):
            call()


@pytest.mark.cuda
def test_banded_conv_routing_on_the_card(gen):
    """FPNHybridFusion at the ini widths, fp32: 4 K10 launches per
    forward (the extents instance when bucketed) and one train step's 4
    weight gradients, with no data gradient."""
    from types import SimpleNamespace
    from multimodal_fusion_fpn_torch import losses as tlosses
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    from multimodal_fusion_fpn_torch.train.optim import sgd
    from multimodal_fusion_fpn_torch.train.state import create_train_state
    from multimodal_fusion_fpn_torch.train.step import make_train_step
    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)
    model = build_model(cfg)
    image = torch.randn(1, 1, 12, 72, 48, generator=gen, device="cuda")
    slo = torch.randn(1, 1, 88, 1, 48, generator=gen, device="cuda")
    padded = {"image": F.pad(image, (0, 16, 0, 8, 0, 4)),
              "slo": F.pad(slo, (0, 16, 0, 0, 0, 8)),
              "__valid_image__": (12, 72, 48), "__valid_enface__": (88, 48)}
    K10 = ("banded_conv", "banded_conv_dyn", "banded_conv_wgrad",
           "banded_conv_dgrad")
    for batch, want in (({"image": image, "slo": slo}, (4, 0, 0, 0)),
                        (padded, (0, 4, 0, 0))):
        ops.reset_launches()
        with torch.inference_mode():
            model(batch)
        torch.cuda.synchronize()
        assert tuple(ops.kernel_launches()[k] for k in K10) == want
    opt = sgd(model.parameters(), 0.1)
    crit = tlosses.Mix({"Dice Loss": tlosses.dice_loss_joint(),
                        "BCE loss": tlosses.bce_loss()})
    step = make_train_step(model, opt, crit)
    mask = (torch.rand(1, 1, 12, 1, 48, generator=gen, device="cuda")
            > 0.7).float()
    ops.reset_launches()
    step(create_train_state(model, opt), {"image": image, "slo": slo,
                                          "mask": mask})
    torch.cuda.synchronize()
    assert tuple(ops.kernel_launches()[k] for k in K10) == (4, 0, 4, 0)
