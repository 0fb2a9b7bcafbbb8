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

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
# The JAX references of the port's CPU test files compile at LLVM
# optimisation level 0 (``compile_ref``).  A reference is traced once and
# run once on a small input, so its cost is XLA's compile, and the CPU
# backend spends most of that in LLVM's optimisation passes on several
# threads, which under pytest-xdist take the cores from the other workers:
# level 0 halves the CPU time of a full-width FPNHybridFusion compile.  The
# forward references compiled so agree with the default level's to a few
# float32 ulps, far inside the tolerances; the float64 train steps of
# ``tests/test_torch_train.py`` returned NaN losses there, so that file
# chooses a level per step (its ``LEVELS``).
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}


def compile_ref(lowered):
    """``lowered.compile()`` at LLVM optimisation level 0 (see above)."""
    return lowered.compile(COMPILE_OPTIONS)


def jax_template(sd):
    """The JAX trees' structure and shapes ({"params", "batch_stats"} of
    ``jax.ShapeDtypeStruct``) for the port's state dict ``sd``, by the JAX
    package's own name table (``map_state_dict`` with nothing to check
    against), with no JAX trace of the model's init.  That the table gives
    the JAX model's own trees is held here for the hybrid
    (``test_state_dict_round_trips_through_torch_import``) and for the
    late-fusion net, both trunks, in ``tests/test_torch_zoo.py``."""
    params, stats = map_state_dict(sd, {}, {}, strict=False)
    shapes = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.float32), t)
    return {"params": shapes(params), "batch_stats": shapes(stats)}


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
STAGE_CASES = [(3, 1, 16), (3, 16, 32), (3, 16, 16), (2, 1, 16), (2, 16, 32)]
ZDIM_CASES = [1, 2, 3, 4]


def _stage_case(ndim, ci, co):
    rng = np.random.default_rng(ci + co + ndim)
    shape = (2, 3, 5, 16, ci) if ndim == 3 else (2, 6, 16, ci)
    x = rng.normal(size=shape).astype(np.float32)
    return x, jblocks.EncoderStage(co, downsample=ci != co, ndim=ndim)


def _zdim_case(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(1, 2, 3, 64, 16)).astype(np.float32)
    return x, jblocks.ZDimReduction(16, num_reductions=n, final_kernel=4)


@pytest.fixture(scope="module")
def block_refs(fused_on):
    """(params, stats, JAX output) of every stage and projection-head case
    below: all traced into one function, compiled once (one compile of
    the lot costs less than the twelve apart)."""
    cases = ([(("stage",) + c, _stage_case(*c), c[0] * 100 + c[2])
              for c in STAGE_CASES]
             + [(("zdim", n), _zdim_case(n), 10 + n) for n in ZDIM_CASES])
    modules, args = [], []
    for key, (x, jm), seed in cases:
        template = jax.eval_shape(
            lambda jm=jm, x=x: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
        params, stats = random_trees(template, seed=seed)
        modules.append(jm)
        args.append((params, stats, jnp.asarray(x)))

    def outputs(args):
        return [jm.apply({"params": p, "batch_stats": s}, a, train=False)
                for jm, (p, s, a) in zip(modules, args)]

    outs = compile_ref(jax.jit(outputs).lower(args))(args)
    return {key: (p, s, np.asarray(o))
            for (key, _, _), (p, s, _), o in zip(cases, args, outs)}


@pytest.mark.parametrize("ndim,ci,co", STAGE_CASES)
def test_encoder_stage_matches_jax(block_refs, ndim, ci, co):
    x, _ = _stage_case(ndim, ci, co)
    params, stats, ref = block_refs[("stage", ndim, ci, co)]
    tm = tblocks.EncoderStage(ci, co, ndim).eval()
    tm.load_state_dict(_sub_state_dict("conv1", params, stats), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n", ZDIM_CASES)
def test_zdim_reduction_matches_jax(block_refs, n):
    x, _ = _zdim_case(n)
    params, stats, ref = block_refs[("zdim", n)]
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


@pytest.fixture(scope="module")
def jax_hybrid(hybrid_weights):
    """JAX FPNHybridFusion predictions per (alignment, fused mode), for
    both alignments in fused modes 'on' and 'auto': the four models traced
    into one function (the fused mode, a global of the JAX package, set
    before each is traced) and compiled once.  XLA merges what the four
    share (in one fused mode both alignments run the same encoders on the
    same inputs), so one compile costs about half of the four apart."""
    batch, _, params, stats = hybrid_weights
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = [(crop, mode) for crop in ("relative_2d_max", "relative_2d")
            for mode in ("on", "auto")]
    models = {k: jbuild(_cfg(k[0]), remat=False) for k in keys}

    def predictions(p, s, b):
        out = []
        for crop, mode in keys:
            jblocks.set_fused_stage_mode(mode)
            out.append(models[(crop, mode)].apply(
                {"params": p, "batch_stats": s}, b,
                train=False)["prediction"])
        return out

    prev = jblocks._FUSED_MODE
    try:
        lowered = jax.jit(predictions).lower(params, stats, jb)
    finally:
        jblocks.set_fused_stage_mode(prev)
    outs = compile_ref(lowered)(params, stats, jb)
    return {k: np.asarray(o) for k, o in zip(keys, outs)}


def port_hybrid(hybrid_weights, crop, dtype=torch.float32):
    batch, _, params, stats = hybrid_weights
    model = build_model(_cfg(crop), dtype=dtype, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return out["prediction"]


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("crop", ["relative_2d_max", "relative_2d"])
def test_hybrid_fusion_matches_jax(hybrid_weights, jax_hybrid, crop, mode):
    """Both alignments ('2d_max', '2d'); the JAX package in fused mode
    'on' and in its default mode (per-op convs off-TPU)."""
    ref = jax_hybrid[(crop, mode)]
    got = port_hybrid(hybrid_weights, crop).numpy()
    assert got.shape == ref.shape == (1, 1, 8, 1, 32)
    np.testing.assert_allclose(got, ref, **TOL)


def test_hybrid_fusion_bf16_close_to_jax_fp32(hybrid_weights, jax_hybrid):
    """bf16 against the fp32 JAX result, on the prediction centred at 0.5
    (the sigmoid's odd part: a plain cosine of values near 0.5 would pass
    for any output)."""
    ref = jax_hybrid[("relative_2d_max", "on")] - 0.5
    got = port_hybrid(hybrid_weights, "relative_2d_max", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    a, b = got.float().numpy().ravel() - 0.5, ref.ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    ratio = np.linalg.norm(a) / np.linalg.norm(b)
    assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (cos, ratio)


def test_hybrid_regression_is_the_hybrid_before_the_sigmoid(
        hybrid_weights, jax_hybrid):
    """``FPNHybridFusionRegression`` differs only in its head: its output
    through a sigmoid meets the JAX hybrid's prediction (1e-4) and the
    port's hybrid bit for bit."""
    batch, _, params, stats = hybrid_weights
    cfg = make_config(model="FPNHybridFusionRegression",
                      crop="relative_2d_max", fusion_modality="slo")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        logits = model({k: torch.from_numpy(v)
                        for k, v in batch.items()})["prediction"]
    got = torch.sigmoid(logits).numpy()
    np.testing.assert_allclose(got, jax_hybrid[("relative_2d_max", "on")],
                               **TOL)
    np.testing.assert_array_equal(
        got, port_hybrid(hybrid_weights, "relative_2d_max").numpy())


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
    # the name table alone gives the init's trees (``jax_template``)
    la = jax.tree.leaves_with_path(template)
    lb = jax.tree.leaves_with_path(jax_template(model.state_dict()))
    assert [(p, x.shape, x.dtype) for p, x in la] == [
        (p, x.shape, x.dtype) for p, x in lb]


# kernel-wrapper calls per member forward at the ini widths: the hybrid's
# 35 (1,*,*) fused convs are its 3D and 2D stages' 13 + 13 and its
# cascades' 4 + 3 + 2; FPN has the 3D half, FPN2D the 2D half; each net
# pools 4 times, its 128-channel stage-4 pool with the first-max rule
ROUTING = {"FPNHybridFusion": {"k1": 35, "k2": 6, "pool": 8, "first_max": 2},
           "FPN": {"k1": 22, "k2": 3, "pool": 4, "first_max": 1},
           "FPN2D": {"k1": 13, "k2": 3, "pool": 4, "first_max": 1}}


def test_kernel_routing_counts_per_member(monkeypatch):
    """Which calls take the kernels on the main path, counted on the CPU
    by spies on the wrappers (``ROUTING``), for the hybrid and for each of
    its halves as a model of its own; ``kernels=False`` calls none."""
    seen = {"k1": 0, "k2": 0, "pool": 0, "first_max": 0}
    real_conv, real_pool = tblocks.fused_conv, tenc.max_pool3d_cl

    def conv_spy(x, s, b, w, relu, stride_z=1, dyn_extents=None):
        seen["k2" if w.shape[0] == 3 else "k1"] += 1
        assert w.shape[3] >= 8 and w.shape[4] <= 64 and dyn_extents is None
        return real_conv(x, s, b, w, relu, stride_z)

    def pool_spy(x, window, first_max=False):
        seen["pool"] += 1
        seen["first_max"] += first_max
        return real_pool(x, window, first_max)

    monkeypatch.setattr(tblocks, "fused_conv", conv_spy)
    monkeypatch.setattr(tenc, "max_pool3d_cl", pool_spy)
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    for name, want in ROUTING.items():
        cfg = make_config(model=name, crop="relative_2d_max",
                          fusion_modality="slo")
        model = build_model(cfg, device="cpu")
        for kernels in (True, False):
            seen.update(k1=0, k2=0, pool=0, first_max=0)
            with torch.no_grad():
                model(batch, kernels=kernels)
            assert seen == (want if kernels else dict.fromkeys(want, 0)), \
                (name, kernels)


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
