"""The architecture ini's toggles, the hybrid's ``feature_fusion="add"``
and the kernels' width rule, on the CPU.

* (a) The width rule.  For every ``ConvX`` of the hybrid and of FPN2D at
  ``tiny_spec``, the ini widths, (8, ..., 128), (24, ..., 384) and
  (32, ..., 512), in eval (the hybrid also under ``block_fusion`` "pair"
  and "chain") and in training, fp32 and bf16: each call that the port
  routes to a kernel wrapper passes that wrapper's CUDA check, applied
  here to the tensors the wrapper received; a conv of a block that the
  JAX package lowers to its Pallas kernels (``fused_stage_bs``,
  ``ZDimReduction._fused_bs``) goes to a kernel exactly when the
  wrapper's predicate (``takes``) takes it.  The convs return zeros of
  their output's shape, type and autograd flag (routing reads nothing
  else).
* (b) The decoder's transposed conv (``blocks.UpConv``) against flax's
  ``nn.ConvTranspose`` at the up factors (2, 2, 1) and (1, 2, 1), its
  weights carried over by ``weights.state_dict_from_jax``.
* (c) The eval forward against the JAX package at ``tiny_spec``: the
  hybrid with ``is_batchnorm=False``, with ``is_deconv=True``, and with
  both and ``feature_fusion="add"``; FPN2D with both.  fp32 at rtol = atol
  = 1e-4.
* (d) One train step of FPN2D with both toggles against the JAX
  ``make_train_step`` in float64 (JAX fused mode "off"): the loss, its
  parts, the metrics and every parameter after the step, per tensor to
  max-abs-err <= 1e-4 * max|ref|; there is no running stat to compare.
  The references of (c) and (d) are traced one after the other, each
  compiled in a thread once traced, at LLVM optimisation level 0
  (``test_torch_model.compile_ref``; without BatchNorm the float64 step
  is finite there).
* (e) The name table: JAX trees with conv biases and ``up`` kernels ->
  the port's state dict -> JAX trees, from the name table alone (no traced
  init; the JAX package's ``torch_import`` has no ``up`` entry, so the
  ``up`` leaves are added by hand: ROADMAP, "Reference faults"); and a
  ``save_checkpoint`` / ``load_checkpoint`` round trip.
* (f) Bucketed eval without BatchNorm: the no-BN deconv hybrid on a
  zero-padded batch with its true extents against its run on the unpadded
  batch, port against port, kernels and plain alike.
* (g) The entry points: the train twin with an ini that sets both toggles
  (FPN2D at ``tiny_spec``, 1 epoch of 2 steps), then the serving twin on
  that run's ``last.ckpt``.  No JAX compile.

Weights come from a numpy seed in the JAX package's tree layout
(``test_torch_model.random_trees``), carried to the port with
``state_dict_from_jax``.
"""

import concurrent.futures
import contextlib
import os
import shutil
from os.path import join

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu import losses as jlosses
from multimodal_fusion_fpn_tpu.models import blocks as jblocks
from multimodal_fusion_fpn_tpu.models import zoo as jzoo
from multimodal_fusion_fpn_tpu.models.arch_config import ArchSpec as JSpec
from multimodal_fusion_fpn_tpu.train import optim as joptim
from multimodal_fusion_fpn_tpu.train.state import TrainState as JState
from multimodal_fusion_fpn_tpu.train.step import make_train_step as jstep
from multimodal_fusion_fpn_tpu.train.torch_import import map_state_dict

from multimodal_fusion_fpn_torch import losses as tlosses
from multimodal_fusion_fpn_torch import train as ttrain
from multimodal_fusion_fpn_torch import validate_ensemble as tve
from multimodal_fusion_fpn_torch.config import make_config
from multimodal_fusion_fpn_torch.data.synthetic import make_synthetic_hrf
from multimodal_fusion_fpn_torch.models import blocks as tblocks
from multimodal_fusion_fpn_torch.models import zoo as tzoo
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.ops import banded_conv as tbc
from multimodal_fusion_fpn_torch.ops import fused_block as tfb
from multimodal_fusion_fpn_torch.ops import fused_conv as tfc
from multimodal_fusion_fpn_torch.train.checkpoints import (
    find_topk_checkpoints, load_checkpoint, save_checkpoint)
from multimodal_fusion_fpn_torch.train.optim import sgd
from multimodal_fusion_fpn_torch.train.state import create_train_state
from multimodal_fusion_fpn_torch.train.step import make_train_step
from multimodal_fusion_fpn_torch.weights import (init_state_dict,
                                                 state_dict_from_jax)

from test_torch_model import compile_ref, jax_template, random_trees
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = (2, 4, 8, 16, 32)
WIDTHS = {"tiny": TINY, "ini": (16, 32, 64, 128, 256),
          "w8": (8, 16, 32, 64, 128), "w24": (24, 48, 96, 192, 384),
          "w32": (32, 64, 128, 256, 512)}


def _port(name, spec, **kw):
    """A port zoo model at fp32 on the CPU (eval mode)."""
    if name.startswith("FPNHybridFusion"):
        kw.setdefault("interpolate", "2d_max")
    return getattr(tzoo, name)(spec=spec, fusion_modality="slo",
                               **kw).eval()


def _jax(name, spec, dtype=jnp.float32, **kw):
    if name.startswith("FPNHybridFusion"):
        kw.update(interpolate="2d_max", remat=False)
    return getattr(jzoo, name)(spec=JSpec(**spec.__dict__),
                               fusion_modality="slo", dtype=dtype, **kw)


def arch_template(sd):
    """``test_torch_model.jax_template`` of the port's state dict ``sd``,
    with the leaves of the decoder's transposed convs added by hand
    (flax's (k..., I, O) kernel and (O,) bias), which the JAX package's
    name table lacks."""
    up = {k: v for k, v in sd.items() if ".up." in k}
    template = jax_template({k: v for k, v in sd.items() if ".up." not in k})
    for k, v in up.items():
        root, mod, _, leaf = k.split(".")
        node = template["params"][root][mod].setdefault("up", {})
        if leaf == "weight":
            node["kernel"] = jax.ShapeDtypeStruct(
                tuple(v.shape[2:]) + tuple(v.shape[:2]), np.float32)
        else:
            node["bias"] = jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
    return template


def _batch(seed, b=1, y=8, d=64, w=32, eh=80):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(b, 1, y, d, w)).astype(np.float32),
            "slo": rng.normal(size=(b, 1, eh, 1, w)).astype(np.float32),
            "mask": (rng.random((b, 1, y, 1, w)) > 0.7).astype(np.float32)}


def _tensors(batch, dtype=None):
    return {k: torch.as_tensor(v if dtype is None else v.astype(dtype))
            for k, v in batch.items()}


# --- (a) the width rule ----------------------------------------------------

def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _stub(shape, dtype, *inputs):
    """Zeros of ``shape`` that require grad where an input does: what the
    width rule reads of a conv's output (its shape, type and autograd
    flag), without the conv's arithmetic, which (c) and (d) hold."""
    out = torch.zeros(shape, dtype=dtype)
    tie = [t.sum() for t in inputs if t is not None and t.requires_grad]
    return out + 0 * sum(tie) if tie and torch.is_grad_enabled() else out


def _conv_shape(x, w, stride, pad):
    return (x.shape[0],) + tuple(
        (n + 2 * p - k) // s + 1
        for n, k, s, p in zip(x.shape[1:4], w.shape[:3], stride, pad)) + (
            w.shape[4],)


@pytest.fixture
def routed(monkeypatch):
    """Spies on the kernel wrappers that ``blocks`` calls: each call is
    held to the wrapper's CUDA check (on the tensors it received) and
    recorded; ``ConvX._conv`` is held to route a conv of a fused block to
    a kernel exactly where the predicate takes it.  Every conv, the plain
    ones too, returns ``_stub``'s zeros."""
    seen = []

    def fused_conv(x, s, b, w, relu, stride_z=1, with_stats=False,
                   dyn_extents=None):
        tfc._check(x, s, b, w, stride_z)
        if _needs_grad(x, s, b, w):
            tfc._check_bwd(x, w, stride_z)
        seen.append(("fused_conv", x.shape[-1], w.shape[4]))
        y = _stub(tfc._out_shape(x, w, stride_z), x.dtype, x, s, b, w)
        if not with_stats:
            return y
        return y, *tfc.channel_sums(y)

    def banded_conv(x, w, dyn_extents=None):
        tbc._check(x, w.shape, [("w", w, None)],
                   training=_needs_grad(x))
        seen.append(("banded_conv", x.shape[-1], w.shape[4]))
        return _stub(x.shape[:4] + (w.shape[4],), x.dtype, x, w)

    def fused_chain(x, s_in, b_in, relu0, convs, final, ds=None,
                    dyn_extents=None):
        tfb._check("fused_chain", x, s_in, b_in, convs, final, ds)
        seen.append(("fused_chain", x.shape[-1], convs[0][0].shape[4]))
        return _stub(x.shape[:4] + (convs[0][0].shape[4],), x.dtype)

    def fused_pair(x, s0, b0, w0, s_mid, b_mid, w1, relu0,
                   dyn_extents=None):
        tfb._check("fused_pair", x, s0, b0,
                   [(w0, s_mid, b_mid), (w1, None, None)], "raw", None)
        seen.append(("fused_pair", x.shape[-1], w0.shape[4]))
        return _stub(x.shape[:4] + (w1.shape[4],), x.dtype)

    def conv3d_cl(t, w, stride, padding):
        return _stub(_conv_shape(t, w, stride, padding), t.dtype, t, w)

    def conv(self, x, s, b, w, relu, stride_z, kernels, ext):
        n = len(seen)
        out = real_conv(self, x, s, b, w, relu, stride_z, kernels, ext)
        ci, co, taps = w.shape[3], w.shape[4], tuple(w.shape[:3])
        if ci >= 8:
            takes = tfc.takes(ci, co, taps, stride_z,
                              _needs_grad(x, s, b, w), x.dtype)
        else:
            takes = tbc.takes(ci, co, taps, stride_z, _needs_grad(x, s, b),
                              x.dtype)
        want = kernels and self.fused and self.padding == "same" and takes
        assert (len(seen) > n) == want, (ci, co, taps, stride_z, x.dtype)
        return out

    real_conv = tblocks.ConvX._conv
    spies = dict(fused_conv=fused_conv, banded_conv=banded_conv,
                 fused_chain=fused_chain, fused_pair=fused_pair,
                 conv3d_cl=conv3d_cl)
    for name, spy in spies.items():
        monkeypatch.setattr(tblocks, name, spy)
    monkeypatch.setattr(tblocks.ConvX, "_conv", conv)
    return seen


def _jax_fuses(model):
    """Each fused-flagged stage and cascade of the port model against the
    JAX package's rule for lowering it to its Pallas kernels (fused mode
    "on", a depth of 64)."""
    prev = jblocks._FUSED_MODE
    jblocks.set_fused_stage_mode("on")
    try:
        for name, m in model.named_modules():
            if isinstance(m, tblocks.EncoderStage):
                co = m[1].convBlock[0][0].weight.shape[0]
                bn = len(m[1].convBlock[0]) == 2
                want = jblocks.fused_stage_bs(64, co, bn, m[0].dropout,
                                              m.ndim) is not None
                assert m.fused == want, name
            elif isinstance(m, tblocks.ZDimReduction) and len(m) == 2:
                red = m[0]
                c = red.convBlock[0][0].weight.shape[0]
                jm = jblocks.ZDimReduction(
                    c, num_reductions=len(red.convBlock),
                    use_bn=len(red.convBlock[0]) == 2)
                want = jm._fused_bs(np.zeros((1, 2, 4, 64, c))) is not None
                assert red.fused == want, name
    finally:
        jblocks.set_fused_stage_mode(prev)


@pytest.mark.parametrize("model", ["FPNHybridFusion", "FPN2D"])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_width_rule(routed, model, widths):
    net = _port(model, ArchSpec(WIDTHS[widths]))
    _jax_fuses(net)
    batch = _batch(1, y=4, d=64, w=16, eh=16)
    fusions = (None, "pair", "chain") if model == "FPNHybridFusion" else (
        None,)
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        net.to(dtype)
        b = _tensors(batch)
        net.dtype = dtype
        net.eval()
        with torch.no_grad():
            for fusion in fusions:
                routed.clear()
                net(b, block_fusion=fusion)
                counts[(str(dtype), fusion)] = len(routed)
        net.train()
        routed.clear()
        net(b)
        counts[(str(dtype), "train")] = len(routed)
    # at the default widths every fused conv takes a kernel
    if widths == "ini":
        assert min(counts.values()) > 0, counts


# --- (b) the up step -------------------------------------------------------

@pytest.mark.parametrize("upfactor", [(2, 2, 1), (1, 2, 1)])
def test_up_step_matches_flax_conv_transpose(upfactor):
    rng = np.random.default_rng(sum(upfactor))
    ci, co = 6, 4
    x = rng.normal(size=(2, 3, 5, 1, ci)).astype(np.float32)
    params = {"kernel": rng.normal(size=upfactor + (ci, co)).astype(
        np.float32), "bias": rng.normal(size=(co,)).astype(np.float32)}
    up = fnn.ConvTranspose(co, kernel_size=upfactor, strides=upfactor)
    ref = np.asarray(up.apply({"params": params}, jnp.asarray(x)))
    sd = state_dict_from_jax({"r": {"up_concat1": {"up": params}}}, {})
    port = tblocks.UpConv(ci, co, upfactor)
    port.load_state_dict({k[len("r.up_concat1.up."):]: v
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 3 * upfactor[0], 5 * upfactor[1],
                                      1, co)
    np.testing.assert_allclose(got, ref, **TOL)


# --- (c), (d) the models against JAX ---------------------------------------

# (model, is_batchnorm, is_deconv, feature_fusion)
FORWARD_CASES = [("FPNHybridFusion", False, False, "concat"),
                 ("FPNHybridFusion", True, True, "concat"),
                 ("FPNHybridFusion", False, True, "add"),
                 ("FPN2D", False, True, None)]


def _spec(bn, deconv, channels=TINY):
    return ArchSpec(channels, is_batchnorm=bn, is_deconv=deconv)


def _kw(fusion):
    return {} if fusion is None else {"feature_fusion": fusion}


def _forward_refs(pool):
    """The JAX eval prediction of each of ``FORWARD_CASES`` (futures: each
    compiles in ``pool`` once traced, while the next is traced) and each
    case's port model with the same weights."""
    batch = _batch(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ports, preds = [], []
    for i, (name, bn, deconv, fusion) in enumerate(FORWARD_CASES):
        spec = _spec(bn, deconv)
        port = _port(name, spec, **_kw(fusion))
        params, stats = random_trees(arch_template(port.state_dict()),
                                     seed=20 + i)
        port.load_state_dict(state_dict_from_jax(params, stats),
                             strict=True)
        ports.append(port)
        jm = _jax(name, spec, **_kw(fusion))
        lowered = jax.jit(lambda p, s, b, jm=jm: jm.apply(
            {"params": p, "batch_stats": s}, b,
            train=False)["prediction"]).lower(params, stats, jb)
        preds.append(pool.submit(
            lambda lo=lowered, p=params, s=stats: np.asarray(
                compile_ref(lo)(p, s, jb))))
    return batch, ports, preds


def _criterion(mod):
    return mod.Mix({"Dice Loss": mod.dice_loss_joint(),
                    "BCE loss": mod.bce_loss()})


def _step_ref(pool):
    """One JAX ``make_train_step`` of FPN2D with both toggles in float64
    (fused mode "off"), traced here and compiled in ``pool``: the numpy
    (params, aux) after it (a future), the weights' trees and the
    batch."""
    spec = _spec(False, True)
    port = _port("FPN2D", spec)
    params, stats = random_trees(arch_template(port.state_dict()), seed=31)
    assert not stats
    wide = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), t)
    params = wide(params)
    batch = {k: v.astype(np.float64) for k, v in _batch(8, b=2).items()}
    prev = jblocks._FUSED_MODE
    jblocks.set_fused_stage_mode("off")
    try:
        with jax.enable_x64(True):
            tx = joptim.sgd(0.1)
            opt0 = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                jax.eval_shape(tx.init, params))
            state = JState(step=jnp.asarray(0), params=params,
                           batch_stats={}, opt_state=opt0)
            model = _jax("FPN2D", spec, dtype=jnp.float64)
            key = jax.random.PRNGKey(1)
            lowered = jstep(model, tx, _criterion(jlosses),
                            donate=False).lower(state, batch, key)
    finally:
        jblocks.set_fused_stage_mode(prev)

    def run():
        with jax.enable_x64(True):
            new, aux = compile_ref(lowered)(state, batch, key)
            return (jax.tree.map(np.asarray, new.params),
                    jax.tree.map(np.asarray, aux))

    return pool.submit(run), params, batch


@pytest.fixture(scope="module")
def jax_refs():
    """The references of (c) and (d), traced one after the other and
    compiled side by side."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        batch, ports, preds = _forward_refs(pool)
        step, params, step_batch = _step_ref(pool)
        yield {"batch": batch, "ports": ports, "preds": preds,
               "step": step, "params": params, "step_batch": step_batch}


@pytest.mark.parametrize("case", range(len(FORWARD_CASES)),
                         ids=["hybrid-nobn", "hybrid-deconv",
                              "hybrid-both-add", "fpn2d-both"])
def test_forward_matches_jax(jax_refs, case):
    port = jax_refs["ports"][case]
    with torch.no_grad():
        got = port(_tensors(jax_refs["batch"]))["prediction"].numpy()
    ref = jax_refs["preds"][case].result()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def _close(got, ref, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, peak = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 1e-4 * peak, (what, err, peak)


def test_train_step_matches_jax(jax_refs):
    """FPN2D, both toggles, float64: the loss, parts, metrics and every
    parameter after one SGD step; the port's pools take the first-max
    backward (no stage is fused without BatchNorm), as JAX's off the
    TPU."""
    model = tzoo.build_model(
        make_config(model="FPN2D", crop="relative_2d_max",
                    fusion_modality="slo"),
        spec=_spec(False, True), device="cpu", dtype=torch.float64).double()
    opt = sgd(model.parameters(), 0.1)
    state = create_train_state(
        model, opt, state_dict_from_jax(jax_refs["params"], {}))
    step = make_train_step(model, opt, _criterion(tlosses), device="cpu")
    aux = step(state, _tensors(jax_refs["step_batch"]))
    (params, jaux) = jax_refs["step"].result()
    want = state_dict_from_jax(params, {})
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v.numpy(), k)
    _close(aux["loss"], jaux["loss"], "loss")
    assert set(aux["parts"]) == set(jaux["parts"])
    for k, v in aux["parts"].items():
        _close(v, jaux["parts"][k], k)
    for k in ("Dice", "BCE"):
        _close(aux["metrics"][k], jaux["metrics"][k], k)


# --- (e) the name table ----------------------------------------------------

def test_name_table_round_trips_biases_and_up_kernels(tmp_path):
    port = _port("FPNHybridFusion", _spec(False, True))
    template = arch_template(port.state_dict())
    params, stats = random_trees(template, seed=41)
    sd = state_dict_from_jax(params, stats)
    assert not stats
    port.load_state_dict(sd, strict=True)
    names = set(sd)
    assert "resensnet.conv1.0.convBlock.0.0.bias" in names
    assert "resensnet.conv2_2d.0.downsample.0.bias" in names
    assert "resensnet.zdimRed1.0.downsample.0.bias" in names
    assert {f"resensnet.up_concat{i}.up.{leaf}" for i in range(1, 5)
            for leaf in ("weight", "bias")} <= names
    # back: the JAX package's table for all but ``up``, whose kernel is
    # flipped back in every tap axis
    back, back_stats = map_state_dict(
        {k: v for k, v in sd.items() if ".up." not in k}, {}, {},
        strict=False)
    assert not back_stats
    for i in range(1, 5):
        w = sd[f"resensnet.up_concat{i}.up.weight"].numpy()
        back["resensnet"][f"up_concat{i}"]["up"] = {
            "kernel": np.flip(w.transpose(2, 3, 4, 0, 1), (0, 1, 2)),
            "bias": sd[f"resensnet.up_concat{i}.up.bias"].numpy()}
    la = jax.tree.leaves_with_path(params)
    lb = jax.tree.leaves_with_path(back)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the port's checkpoint layout keeps them
    save_checkpoint(str(tmp_path / "a.ckpt"), port.state_dict())
    loaded = load_checkpoint(str(tmp_path / "a.ckpt"), port.state_dict())
    assert set(loaded) == names
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())


# --- (f) bucketed eval without BatchNorm -----------------------------------

def test_bucketed_no_bn_deconv_hybrid_matches_unbucketed():
    """The no-BN deconv hybrid ("add") with every conv bias and up bias
    far from zero, on the zero-padded batch with its true extents against
    its run on the unpadded batch (1e-5): each conv's input is masked to
    the true extents after its bias, so the padding reads 0 as the SAME
    padding of the unpadded run does; the control, extents claiming the
    padded shape, moves the prediction."""
    port = _port("FPNHybridFusion", _spec(False, True),
                 feature_fusion="add")
    init_state_dict(port, 5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for k, p in port.named_parameters():
            if k.endswith("bias"):
                p.normal_(0.0, 0.5, generator=gen)
    y, z, x, eh = 8, 64, 32, 80
    batch = {k: v for k, v in _batch(9, y=y, d=z, w=x, eh=eh).items()
             if k != "mask"}
    pad = lambda a, dims: np.pad(a, [(0, dims.get(i, a.shape[i])  # noqa
                                      - a.shape[i]) for i in range(a.ndim)])
    padded = {"image": pad(batch["image"], {2: 16, 3: 96, 4: 48}),
              "slo": pad(batch["slo"], {2: 96, 4: 48}),
              "__valid_image__": np.asarray([y, z, x], np.int32),
              "__valid_enface__": np.asarray([eh, x], np.int32)}
    with torch.no_grad():
        ref = port(_tensors(batch))["prediction"].numpy()
        for kernels in (True, False):
            got = port(_tensors(padded), kernels=kernels)["prediction"]
            np.testing.assert_allclose(got.numpy()[:, :, :y, :, :x], ref,
                                       rtol=1e-5, atol=1e-5)
        bad = dict(padded, __valid_image__=np.asarray([16, 96, 48],
                                                      np.int32),
                   __valid_enface__=np.asarray([96, 48], np.int32))
        got = port(_tensors(bad))["prediction"].numpy()[:, :, :y, :, :x]
    assert np.abs(got - ref).max() > 1e-3


# --- (g) the entry points --------------------------------------------------

INI = """[architecture]
architecture-name=ModifiedUnet3D
is-deconv=true
channels=2,4,8,16,32
dropout=0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0
is-batchnorm=false
"""


@contextlib.contextmanager
def _cwd(path):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def test_entry_points_run_both_toggles(tmp_path):
    """``train.run`` with an ini that sets both toggles (FPN2D, 1 epoch of
    2 steps), then ``validate_ensemble.run`` on five copies of its
    ``last.ckpt``: finite losses, the toggled model's keys in the
    checkpoint, the ensemble's rows."""
    paths = make_synthetic_hrf(str(tmp_path / "data"), n_patients=8, d=16,
                               h=64, w=32, enface_h=80, enface_w=32, seed=3)
    (tmp_path / "arch.ini").write_text(INI)
    argv = ["--training-dataset", "hrf_fusion", "--model", "FPN2D",
            "--crop", "relative_2d_max", "--fusion-modality", "slo",
            "--version", "arch", "--data-root", paths["oct"],
            "--split-name", "split",
            "--arch-config", str(tmp_path / "arch.ini"),
            "--multiplier", "1", "--batch-size", "2", "--epochs", "1",
            "--threads", "1"]
    (tmp_path / "run").mkdir()
    with _cwd(tmp_path / "run"):
        info = ttrain.run(argv, device="cpu")
        assert info["steps"] == 2 and np.isfinite(info["losses"]).all()
        sd = load_checkpoint(join(info["model_path"], "last.ckpt"))
        assert "resensnet.up_concat1.up.weight" in sd
        assert "resensnet.conv1_2d.0.convBlock.0.0.bias" in sd
        assert not any("running" in k for k in sd)
        for path in find_topk_checkpoints(info["model_path"]):
            os.remove(path)
        for i in range(5):
            shutil.copy(join(info["model_path"], "last.ckpt"),
                        join(info["model_path"],
                             f"epoch={i}-Dice=0.{i}000.ckpt"))
        served = tve.run(argv + ["--eval-batch", "2"], device="cpu")
    assert served["images"] > 0
