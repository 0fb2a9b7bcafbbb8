"""The port's ops against the JAX package's, on the CPU.

Same numpy inputs through both.  fp32 at rtol = atol = 1e-4 (the
full-model parity tolerance); bf16 by cosine and norm ratio against the
fp32 JAX result, since bf16 rounds at other points in the two packages.
The JAX fused conv runs both as its XLA reference (``impl="ref"``) and as
the Pallas kernel body in interpret mode (``impl="pallas"``).  The CUDA
kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_fusion_fpn_tpu.ops import interpolate as jinterp
from multimodal_fusion_fpn_tpu.ops import pooling as jpooling
from multimodal_fusion_fpn_tpu.ops import upsample as jupsample
from multimodal_fusion_fpn_tpu.ops.pallas import fused_conv as jfc
from multimodal_fusion_fpn_tpu.ops.pallas import pool as jpool

from multimodal_fusion_fpn_torch import ops
from multimodal_fusion_fpn_torch.ops import _build
from multimodal_fusion_fpn_torch.ops import fused_conv as tfc
from multimodal_fusion_fpn_torch.ops import pool as tpool
from multimodal_fusion_fpn_torch.ops.interpolate import linear_resize
from multimodal_fusion_fpn_torch.ops.pooling import adaptive_max_pool
from multimodal_fusion_fpn_torch.ops.upsample import upsample_nearest

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
            else jnp.asarray(np.tile(v, bs), dtype))
    y = jfc.fused_conv([jfc.pack(jnp.asarray(x, dtype), bs)], [tile(s)],
                       [tile(b)], jnp.asarray(w, dtype), X, nb, bs,
                       relu=relu, preferred_element_type=dtype, impl=impl)
    return np.asarray(jfc.unpack(y, X, nb, bs), np.float32)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.fixture
def interpret():
    jfc.set_interpret_mode(True)
    yield
    jfc.set_interpret_mode(False)


# (B, Y, X, Z, kshape): 3D (1,3,3), (3,1,1), 1x1x1, and a 2D (1,3) conv
# as (1,1,3) on the singleton-X view
CONV_CASES = [(1, 4, 6, 16, (1, 3, 3)), (1, 4, 6, 16, (3, 1, 1)),
              (2, 3, 5, 16, (1, 1, 1)), (1, 6, 1, 24, (1, 1, 3))]


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: "k" + "".join(map(str, c[4])))
def test_fused_conv_matches_jax(case, relu, affine, impl, request):
    if impl == "pallas":
        request.getfixturevalue("interpret")
    B, Y, X, Z, kshape = case
    x, s, b, w = _conv_inputs(B, Y, X, Z, 8, 16, kshape, affine,
                              seed=sum(kshape) + 2 * relu + affine)
    ref = _jax_fused(x, s, b, w, relu, bs=8, impl=impl)
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
@pytest.mark.parametrize("affine,relu", [(True, True), (False, False),
                                         (True, False)])
def test_stride2_cascade_matches_jax(affine, relu, impl, request):
    """The stride-2 (1,1,3) cascade conv vs ``fused_conv_strided`` on a
    dense input (valid_in = bs) read back with ``unpack_slots``."""
    if impl == "pallas":
        request.getfixturevalue("interpret")
    B, Y, X, Z, bs = 1, 3, 4, 32, 8
    x, s, b, w = _conv_inputs(B, Y, X, Z, 8, 16, (1, 1, 3), affine,
                              seed=11 + affine + 2 * relu)
    nb = Z // bs
    tile = lambda v: None if v is None else jnp.asarray(np.tile(v, bs))
    y = jfc.fused_conv_strided([jfc.pack(jnp.asarray(x), bs)], [tile(s)],
                               [tile(b)], jnp.asarray(w), X, nb, bs,
                               valid_in=bs, relu=relu, impl=impl)
    ref = np.asarray(jfc.unpack_slots(y, X, nb, bs, bs // 2))
    got = tfc.fused_conv(_t(x), _t(s), _t(b), _t(w), relu, stride_z=2)
    assert got.shape == (B, Y, X, (Z + 1) // 2, 16)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_stride2_odd_depth_length():
    x = torch.randn(1, 2, 2, 31, 8)
    got = tfc.fused_conv(x, None, None, torch.randn(1, 1, 3, 8, 16), False,
                         stride_z=2)
    assert got.shape[3] == 16


# windows of the main path: 3D (1,2,2), (2,2,2); 2D (1,2), (2,2) as
# (1,1,2), (2,1,2) on the singleton-X view
@pytest.mark.parametrize("win", [(1, 2, 2), (2, 2, 2), (1, 1, 2),
                                 (2, 1, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_matches_jax_pool_packed(win, dtype):
    rng = np.random.default_rng(sum(win))
    X = 1 if win[1] == 1 else 6
    x = rng.normal(size=(2, 4, X, 32, 16)).astype(np.float32)
    bs = 8
    xj = jnp.asarray(x, dtype)
    out = jpool.pool_packed(jfc.pack(xj, bs), X, 32 // bs, bs, win)
    ref = np.asarray(jfc.unpack(out, X // win[1], 32 // bs, bs // win[2]),
                     np.float32)
    tdt = getattr(torch, dtype)
    got = tpool.max_pool3d_cl(torch.from_numpy(x).to(tdt), win)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_max_pool_floor_sizes():
    x = torch.randn(1, 5, 7, 9, 4)
    got = tpool.max_pool3d_cl(x, (2, 2, 2))
    ref = torch.nn.functional.max_pool3d(x.permute(0, 4, 1, 2, 3), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.permute(0, 2, 3, 4, 1).numpy())


def test_cpu_wrappers_take_plain_path_and_count_nothing():
    ops.reset_launches()
    x = torch.randn(1, 2, 3, 8, 8)
    w = torch.randn(1, 3, 3, 8, 16)
    s, b = torch.randn(8), torch.randn(8)
    torch.testing.assert_close(tfc.fused_conv(x, s, b, w, True),
                               tfc.fused_conv_plain(x, s, b, w, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(tpool.max_pool3d_cl(x, (1, 1, 2)),
                               tpool.max_pool3d_cl_plain(x, (1, 1, 2)),
                               rtol=0, atol=0)
    assert ops.kernel_launches() == {"fused_conv": 0, "fused_conv_ky3": 0,
                                     "max_pool3d_cl": 0}
    assert not tfc.calls and not tpool.calls


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
