"""The port's blocks and FPNHybridFusion against the JAX package, on the CPU.

Weights come from a numpy seed in the JAX package's own tree layout (the
shapes from ``jax.eval_shape`` of its init), with BatchNorm running stats
perturbed so every folded affine is far from the identity, and are carried
to the port with ``state_dict_from_jax``.  fp32 outputs agree at rtol =
atol = 1e-4 (``tests/test_full_model_parity.py``); bf16 is compared by
cosine and norm ratio against the fp32 JAX result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu.config import make_config
from multimodal_fusion_fpn_tpu.models import blocks as jblocks
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.train.torch_import import map_state_dict

from multimodal_fusion_fpn_torch.models import blocks as tblocks
from multimodal_fusion_fpn_torch.models import encoder3d as tenc
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.weights import (init_state_dict,
                                                 state_dict_from_jax)

TOL = dict(rtol=1e-4, atol=1e-4)


def random_trees(template, seed):
    """numpy (params, batch_stats) with the template's structure: conv
    kernels ~ N(0, 1/fan_in), BN scale ~ N(1, 0.1), biases ~ N(0, 0.1),
    running mean ~ N(0, 0.5), running var ~ U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        shape = a.shape
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = rng.normal(1.0, 0.1, size=shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.1, size=shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.5, size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, size=shape)
        else:
            raise KeyError(name)
        return np.asarray(v, np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, template["params"])
    stats = jax.tree_util.tree_map_with_path(leaf, template["batch_stats"])
    return params, stats


def jax_apply(module, params, stats, *args):
    out = jax.jit(lambda p, s, *a: module.apply(
        {"params": p, "batch_stats": s}, *a, train=False))(
            params, stats, *args)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def fused_on():
    """The JAX encoder stages on their fused lowering ('on': the fused
    chain through the XLA reference off-TPU), restored afterwards."""
    prev = jblocks._FUSED_MODE
    jblocks.set_fused_stage_mode("on")
    yield
    jblocks.set_fused_stage_mode(prev)


def _sub_state_dict(tree_name, params, stats):
    """A block's JAX trees -> its port state dict (the conversion works on
    model paths, so the block is placed under a model-level name)."""
    sd = state_dict_from_jax({"r": {tree_name: params}},
                             {"r": {tree_name: stats}})
    prefix = f"r.{tree_name}."
    return {k[len(prefix):]: v for k, v in sd.items()}


# (ndim, ci, co): narrow stage-1 input, a downsample stage, identity residual
@pytest.mark.parametrize("ndim,ci,co", [(3, 1, 16), (3, 16, 32), (3, 16, 16),
                                       (2, 1, 16), (2, 16, 32)])
def test_encoder_stage_matches_jax(fused_on, ndim, ci, co):
    rng = np.random.default_rng(ci + co + ndim)
    shape = (2, 3, 5, 16, ci) if ndim == 3 else (2, 6, 16, ci)
    x = rng.normal(size=shape).astype(np.float32)
    jm = jblocks.EncoderStage(co, downsample=ci != co, ndim=ndim)
    template = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params, stats = random_trees(template, seed=ndim * 100 + co)
    ref = jax_apply(jm, params, stats, jnp.asarray(x))

    tm = tblocks.EncoderStage(ci, co, ndim).eval()
    tm.load_state_dict(_sub_state_dict("conv1", params, stats), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_zdim_reduction_matches_jax(fused_on, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(1, 2, 3, 64, 16)).astype(np.float32)
    jm = jblocks.ZDimReduction(16, num_reductions=n, final_kernel=4)
    template = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params, stats = random_trees(template, seed=10 + n)
    ref = jax_apply(jm, params, stats, jnp.asarray(x))

    tm = tblocks.ZDimReduction(16, n).eval()
    tm.load_state_dict(_sub_state_dict("zdimRed1", params, stats),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def _batch(seed=0, b=1, y=8, d=64, w=32, eh=80, ew=32):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(b, 1, y, d, w)).astype(np.float32),
        "slo": rng.normal(size=(b, 1, eh, 1, ew)).astype(np.float32),
    }


def _cfg(crop):
    return make_config(model="FPNHybridFusion", crop=crop,
                       fusion_modality="slo")


@pytest.fixture(scope="module")
def hybrid_weights():
    """JAX trees for FPNHybridFusion at the ini widths (shared by both
    alignments: they have the same parameters) and the test batch."""
    batch = _batch(2)
    model = jbuild(_cfg("relative_2d_max"), remat=False)
    template = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False))
    params, stats = random_trees(template, seed=5)
    return batch, template, params, stats


_JAX_OUT = {}


def jax_hybrid(hybrid_weights, crop, mode):
    """JAX FPNHybridFusion prediction in fused mode ``mode``, cached."""
    if (crop, mode) not in _JAX_OUT:
        batch, _, params, stats = hybrid_weights
        prev = jblocks._FUSED_MODE
        jblocks.set_fused_stage_mode(mode)
        try:
            out = jax_apply(jbuild(_cfg(crop), remat=False), params, stats,
                            {k: jnp.asarray(v) for k, v in batch.items()})
        finally:
            jblocks.set_fused_stage_mode(prev)
        _JAX_OUT[(crop, mode)] = out["prediction"]
    return _JAX_OUT[(crop, mode)]


def port_hybrid(hybrid_weights, crop, dtype=torch.float32):
    batch, _, params, stats = hybrid_weights
    model = build_model(_cfg(crop), dtype=dtype, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return out["prediction"]


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("crop", ["relative_2d_max", "relative_2d"])
def test_hybrid_fusion_matches_jax(hybrid_weights, crop, mode):
    """Both alignments ('2d_max', '2d'); the JAX package in fused mode
    'on' and in its default mode (per-op convs off-TPU)."""
    ref = jax_hybrid(hybrid_weights, crop, mode)
    got = port_hybrid(hybrid_weights, crop).numpy()
    assert got.shape == ref.shape == (1, 1, 8, 1, 32)
    np.testing.assert_allclose(got, ref, **TOL)


def test_hybrid_fusion_bf16_close_to_jax_fp32(hybrid_weights):
    """bf16 against the fp32 JAX result, on the prediction centred at 0.5
    (the sigmoid's odd part: a plain cosine of values near 0.5 would pass
    for any output)."""
    ref = jax_hybrid(hybrid_weights, "relative_2d_max", "on") - 0.5
    got = port_hybrid(hybrid_weights, "relative_2d_max", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    a, b = got.float().numpy().ravel() - 0.5, ref.ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    ratio = np.linalg.norm(a) / np.linalg.norm(b)
    assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (cos, ratio)


def test_state_dict_round_trips_through_torch_import(hybrid_weights):
    _, template, params, stats = hybrid_weights
    model = build_model(_cfg("relative_2d_max"), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    p2, s2 = map_state_dict(model.state_dict(), template["params"],
                            template["batch_stats"])
    for a, b in ((params, p2), (stats, s2)):
        la, lb = jax.tree.leaves_with_path(a), jax.tree.leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (_, x), (_, y) in zip(la, lb):
            np.testing.assert_array_equal(x, y)


def test_kernel_routing_counts_per_member(monkeypatch):
    """Which calls take the kernels on the main path, counted on the CPU
    by spies on the wrappers: per member 35 (1,*,*) fused convs (3D and
    2D stages 13 + 13, cascades 4 + 3 + 2), 6 (3,1,1) convs and 8 pools."""
    seen = {"k1": 0, "k2": 0, "pool": 0}
    real_conv, real_pool = tblocks.fused_conv, tenc.max_pool3d_cl

    def conv_spy(x, s, b, w, relu, stride_z=1):
        seen["k2" if w.shape[0] == 3 else "k1"] += 1
        assert w.shape[3] >= 8 and w.shape[4] <= 64
        return real_conv(x, s, b, w, relu, stride_z)

    def pool_spy(x, window):
        seen["pool"] += 1
        return real_pool(x, window)

    monkeypatch.setattr(tblocks, "fused_conv", conv_spy)
    monkeypatch.setattr(tenc, "max_pool3d_cl", pool_spy)
    model = build_model(_cfg("relative_2d_max"), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    with torch.no_grad():
        model(batch)
    assert seen == {"k1": 35, "k2": 6, "pool": 8}
    seen.update(k1=0, k2=0, pool=0)
    with torch.no_grad():
        model(batch, kernels=False)
    assert seen == {"k1": 0, "k2": 0, "pool": 0}


def test_training_mode_raises():
    model = build_model(_cfg("relative_2d_max"), device="cpu").train()
    with pytest.raises(NotImplementedError):
        model({k: torch.from_numpy(v) for k, v in _batch().items()})
    with pytest.raises(NotImplementedError):
        tblocks.BNFold(4).train().folded(torch.float32)


def test_init_state_dict_is_seeded():
    model = build_model(_cfg("relative_2d_max"), device="cpu")
    a, b = init_state_dict(model, 0), init_state_dict(model, 0)
    c = init_state_dict(model, 1)
    k = "resensnet.conv2.0.convBlock.0.0.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert a["resensnet.conv1.1.convBlock.2.1.running_var"].eq(1).all()
    # xavier: variance 2 / (fan_in + fan_out) before truncation
    w = a[k]
    assert 0.7 < w.std().item() / np.sqrt(2 / ((16 + 32) * 9)) < 1.1


def test_build_model_defaults_to_cuda():
    """Entry points run on the card unless asked for the CPU; without CUDA
    they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((AssertionError, RuntimeError)):
        build_model(_cfg("relative_2d_max"))
