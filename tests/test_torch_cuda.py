"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
tests directory's ``conftest.py`` imports JAX, which a GPU machine need
not have, so run this file on its own:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

The shapes are small and ragged (extents that are no multiple of the
kernels' tiles); ``chip_smoke.py`` holds the kernels at the main path's
full shapes.  fp32 runs with TF32 off and agrees to max-abs-err <=
1e-4 * max|y|; bf16 by cosine >= 0.999 and a norm ratio within 1%; the
pool is exact.
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
