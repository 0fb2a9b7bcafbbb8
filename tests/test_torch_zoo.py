"""The rest of the port's zoo against the JAX package, on the CPU.

``FPN``, ``FPNClassification``, ``FPN2D`` and ``FPNLateFusion`` at the ini
widths (16/32/64/128/256, so stages 1-3 take the kernels' routes and the
128-channel stage-4 pool its first-max backward) on the small batch of
``tests/test_full_model_parity.py`` (b=1, y=8, d=64, w=32, en-face 80x32),
from numpy-seeded JAX trees (``test_torch_model.random_trees``: BatchNorm
running stats far from the identity) carried over by
``state_dict_from_jax`` and loaded with ``strict=True``.  fp32 outputs
agree to max-abs-err <= 1e-4 * max|y|.

Three JAX forward references, traced one after another and compiled side
by side in threads (``test_torch_model.compile_ref``): ``FPNLateFusion``
with ``output_features``, whose features hold both trunks (the 3D net
without ``final1`` and the en-face net's features aligned to it), so
``FPN`` is held against ``final1`` of its 3D half, computed in numpy;
``FPN2D``, for its resize to the mask; ``FPNClassification`` with three
classes (one class makes its softmax 1).  The Regression variants are
held against their sigmoid twins in the port, with no JAX compile.

FPN's train step (``make_train_step``, Mix(Dice + BCE)) at ``tiny_spec``
against ``jax.value_and_grad`` of the JAX model in train mode plus the
same loss, fp32: the loss, its parts and the new running stats per tensor
to 1e-4 * max|ref|, the gradients as a whole (cosine >= 0.9999, norm
ratio within 1e-3), as ``tests/test_torch_train.py`` holds the hybrid's
fp32 step: a ReLU input within fp32 rounding of 0 flips at other places
in the two packages, which moves single gradient tensors by more.
"""

import concurrent.futures
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu import losses as jlosses
from multimodal_fusion_fpn_tpu.config import make_config
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.train.torch_import import map_state_dict

from multimodal_fusion_fpn_torch import losses as tlosses
from multimodal_fusion_fpn_torch.eval.ensemble import make_ensemble_eval_step
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import (build_model,
                                                    model_factory)
from multimodal_fusion_fpn_torch.train.optim import sgd
from multimodal_fusion_fpn_torch.train.state import create_train_state
from multimodal_fusion_fpn_torch.train.step import make_train_step
from multimodal_fusion_fpn_torch.weights import (init_state_dict,
                                                 state_dict_from_jax)

from test_torch_model import compile_ref, random_trees
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ZOO = ("FPN", "FPNRegression", "FPNClassification", "FPNHybridFusion",
       "FPNHybridFusionRegression", "FPN2D", "FPNLateFusion",
       "FPNLateFusionRegression")
N_CLASSES = {"FPNClassification": 3}


def _cfg(model, output_features=False):
    cfg = make_config(model=model, crop="relative_2d_max",
                      fusion_modality="slo",
                      number_of_outputs=N_CLASSES.get(model, 1))
    cfg.output_features = output_features
    return cfg


def _batch(seed, b=1, y=8, d=64, w=32, eh=80):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(b, 1, y, d, w)).astype(np.float32),
            "slo": rng.normal(size=(b, 1, eh, 1, w)).astype(np.float32),
            "mask": (rng.random((b, 1, y, 1, w)) > 0.7).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, ref, what=""):
    """max|got - ref| <= 1e-4 * max|ref|, the shapes equal."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, peak = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 1e-4 * peak, (what, err, peak)


def _criterion(mod):
    return mod.Mix({"Dice Loss": mod.dice_loss_joint(),
                    "BCE loss": mod.bce_loss()})


# the models with a JAX reference of their own, with the keyword of the
# late-fusion reference
REFS = {"late": ("FPNLateFusion", True), "fpn2d": ("FPN2D", False),
        "cls": ("FPNClassification", False)}


@pytest.fixture(scope="module")
def zoo(tiny_spec):
    """The batch, each reference model's numpy JAX trees, template and
    JAX outputs (futures), FPN's trees and template (``_fpn_trees``), and
    FPN's train-step case at ``tiny_spec`` (``_fpn_grad``).  Every JAX function
    is traced here, one after another, and compiled in a thread while the
    next is traced and the tests run."""
    batch = _batch(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for i, (key, (name, feats)) in enumerate(REFS.items()):
            jm = jbuild(_cfg(name, feats), remat=False)
            template = jax.eval_shape(lambda jm=jm: jm.init(
                {"params": jax.random.PRNGKey(0)}, jb, train=False))
            params, stats = random_trees(template, seed=40 + i)
            lowered = jax.jit(lambda p, s, b, jm=jm: jm.apply(
                {"params": p, "batch_stats": s}, b, train=False)).lower(
                    params, stats, jb)
            out[key] = dict(template=template, params=params, stats=stats,
                            ref=pool.submit(_run, lowered, params, stats,
                                            jb))
        out["grad"] = _fpn_grad(tiny_spec, pool)
        out["fpn"] = _fpn_trees(out["late"])
        yield batch, out


def _fpn_trees(late):
    """FPN's trees and template from the late-fusion reference's: the JAX
    FPN's ``resensnet`` is ``ModifiedUnet3D`` with ``final1``, which the
    late-fusion ``resensnet3d`` is without (``unet3d.py:89-93``), so its
    trees are that trunk plus a seeded ``final1``."""
    rng = np.random.default_rng(44)
    final1 = {"kernel": (rng.normal(size=(1, 1, 1, 16, 1))
                         / 4.0).astype(np.float32),
              "bias": rng.normal(0.0, 0.1, size=(1,)).astype(np.float32)}
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          final1)
    tmpl = late["template"]
    return dict(
        template={"params": {"resensnet": dict(
            tmpl["params"]["resensnet3d"], final1=shapes)},
            "batch_stats": {"resensnet": tmpl["batch_stats"]["resensnet3d"]}},
        params={"resensnet": dict(late["params"]["resensnet3d"],
                                  final1=final1)},
        stats={"resensnet": late["stats"]["resensnet3d"]})


def _run(lowered, *args):
    """Compile ``lowered`` (``compile_ref``) and run it: numpy outputs."""
    return jax.tree.map(np.asarray, compile_ref(lowered)(*args))


def _port(name, trees, batch, output_features=False, **kw):
    model = build_model(_cfg(name, output_features), device="cpu")
    model.load_state_dict(state_dict_from_jax(trees["params"],
                                              trees["stats"]), strict=True)
    with torch.no_grad():
        return {k: v.numpy() for k, v in model(_torch(batch), **kw).items()}


def test_late_fusion_matches_jax(zoo):
    """The prediction and the detached branch features (both trunks)."""
    batch, refs = zoo
    ref = refs["late"]["ref"].result()
    got = _port("FPNLateFusion", refs["late"], batch, output_features=True)
    assert set(got) == set(ref) == {"prediction", "out_features"}
    assert got["out_features"].shape == (1, 32, 8, 1, 32)
    for k in ref:
        _close(got[k], ref[k], k)


def test_fpn_matches_final1_of_the_jax_3d_trunk(zoo):
    """FPN = sigmoid(final1(the late-fusion 3D trunk)), the trunk from the
    JAX reference's features, ``final1`` in numpy."""
    batch, refs = zoo
    trunk = refs["late"]["ref"].result()["out_features"][:, :16].astype(np.float64)
    f1 = refs["fpn"]["params"]["resensnet"]["final1"]
    logits = (np.einsum("bcyzx,co->boyzx", trunk, f1["kernel"][0, 0, 0])
              + f1["bias"][None, :, None, None, None])
    want = 1.0 / (1.0 + np.exp(-logits))
    # FPN reads no en-face key
    got = _port("FPN", refs["fpn"], {"image": batch["image"]})
    assert set(got) == {"prediction"}
    _close(got["prediction"], want)


def test_fpn2d_matches_jax(zoo):
    """The en-face net, its sigmoid resized from 80 x 32 to the mask's
    8 x 32."""
    batch, refs = zoo
    got = _port("FPN2D", refs["fpn2d"], batch)["prediction"]
    assert got.shape == (1, 1, 8, 1, 32)
    _close(got, refs["fpn2d"]["ref"].result()["prediction"])


def test_classification_matches_jax(zoo):
    """``one_one`` on the stage-5 output, the mean over (Y, X, Z) and the
    softmax over 3 classes."""
    batch, refs = zoo
    got = _port("FPNClassification", refs["cls"], batch)["prediction"]
    ref = refs["cls"]["ref"].result()["prediction"]
    assert got.shape == ref.shape == (1, 3)
    assert np.ptp(ref) > 1e-3   # the classes differ
    _close(got, ref)


def test_classification_ignores_the_bucketing_keys(zoo):
    """As the JAX package's does: extents in the batch change nothing
    (ROADMAP Queue 3: on a padded batch its mean then runs over the
    padding)."""
    batch, refs = zoo
    keyed = dict(batch, __valid_image__=np.asarray([4, 32, 16], np.int32),
                 __valid_enface__=np.asarray([40, 16], np.int32))
    a = _port("FPNClassification", refs["cls"], batch)["prediction"]
    b = _port("FPNClassification", refs["cls"], keyed)["prediction"]
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,base,trees", [
    ("FPNRegression", "FPN", "fpn"),
    ("FPNLateFusionRegression", "FPNLateFusion", "late")])
def test_regression_is_its_base_before_the_sigmoid(zoo, name, base, trees):
    """The Regression variants differ only in their head: the sigmoid of
    their prediction is their base model's, bit for bit, and the late
    fusion's features are the same (``FPNHybridFusionRegression``:
    ``tests/test_torch_model.py``)."""
    batch, refs = zoo
    feats = name.startswith("FPNLate")
    reg = _port(name, refs[trees], batch, feats)
    sig = _port(base, refs[trees], batch, feats)
    assert set(reg) == set(sig)
    np.testing.assert_array_equal(
        torch.sigmoid(torch.from_numpy(reg["prediction"])).numpy(),
        sig["prediction"])
    if feats:
        np.testing.assert_array_equal(reg["out_features"],
                                      sig["out_features"])
    assert not np.array_equal(reg["prediction"], sig["prediction"])


@pytest.mark.parametrize("key", ["fpn", "cls", "fpn2d", "late"])
def test_state_dict_round_trips_through_torch_import(zoo, key):
    """``state_dict_from_jax`` gives exactly the port model's keys (strict
    load), and ``torch_import.map_state_dict`` takes its state dict back
    to the same JAX trees: the top-level ``one_one`` and
    ``fusion_module`` and both late-fusion roots, ``resensnet3d`` and
    ``resensnet2d``, included."""
    _, refs = zoo
    name = {"fpn": "FPN", "cls": "FPNClassification", "fpn2d": "FPN2D",
            "late": "FPNLateFusion"}[key]
    trees = refs[key]
    model = build_model(_cfg(name), device="cpu")
    model.load_state_dict(state_dict_from_jax(trees["params"],
                                              trees["stats"]), strict=True)
    p2, s2 = map_state_dict(model.state_dict(), trees["template"]["params"],
                            trees["template"]["batch_stats"])
    for a, b in ((trees["params"], p2), (trees["stats"], s2)):
        la, lb = jax.tree.leaves_with_path(a), jax.tree.leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (_, x), (_, y) in zip(la, lb):
            np.testing.assert_array_equal(x, y)
    roots = {k.split(".")[0] for k in model.state_dict()}
    assert roots == {"fpn": {"resensnet"},
                     "cls": {"resensnet", "one_one"},
                     "fpn2d": {"resensnet"},
                     "late": {"resensnet3d", "resensnet2d",
                              "fusion_module"}}[key]


def test_build_model_builds_every_zoo_name():
    """All eight ``--model`` names, with the JAX package's keyword rules:
    ``interpolate`` for the hybrid and late-fusion families only,
    ``output_features`` for the late-fusion family when the config asks;
    the default device stays the card; an unknown name raises."""
    assert set(model_factory) == set(ZOO)
    spec = ArchSpec((2, 4, 8, 16, 32))
    for name in ZOO:
        model = build_model(_cfg(name, True), spec=spec, device="cpu")
        assert type(model).__name__ == name and not model.training
        interp = getattr(model, "interpolate",
                         getattr(getattr(model, "resensnet", None),
                                 "interpolate", None))
        hybrid = name.startswith(("FPNHybrid", "FPNLate"))
        assert interp == ("2d_max" if hybrid else None), name
        assert getattr(model, "output_features", False) == (
            name.startswith("FPNLate"))
    late = build_model(_cfg("FPNLateFusion"), spec=spec, device="cpu")
    assert not late.output_features
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(types.SimpleNamespace(
            model="FPNNope", crop="relative_2d_max", fusion_modality="slo",
            number_of_outputs=1), spec=spec, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_model(_cfg("FPN"), spec=spec)


@pytest.mark.parametrize("name,where", [("FPN", "encoder level 2 (conv2)"),
                                        ("FPN2D",
                                         "encoder level 2 (conv2_2d)")])
def test_single_modality_nets_refuse_dropout_in_training(name, where):
    """The hybrid's dropout guard (``blocks.refuse_dropout``) in the 3D and
    the en-face nets: eval runs, training raises, naming the stage."""
    drop = (0.0, 0.25) + (0.0,) * 7
    spec = ArchSpec((2, 4, 8, 16, 32), dropout=drop)
    model = build_model(_cfg(name), spec=spec, device="cpu")
    batch = _torch(_batch(1))
    with torch.no_grad():
        assert model(batch)["prediction"].shape == (1, 1, 8, 1, 32)
    model.train()
    with pytest.raises(NotImplementedError,
                       match=rf"dropout slot 1 \({re.escape(where)}\).*"
                             "ROADMAP M8"):
        model(batch)


def test_ensemble_averages_every_output(tiny_spec):
    """The ensemble step averages each output over its members, the
    late-fusion features included, as the JAX step's tree map of the mean
    does."""
    model = build_model(_cfg("FPNLateFusion", True),
                        spec=ArchSpec(tiny_spec.channels), device="cpu")
    sds = [init_state_dict(model, seed) for seed in (5, 6)]
    batch = _torch(_batch(10))
    out = make_ensemble_eval_step(model, sds, device="cpu")(batch)
    each = []
    for sd in sds:
        model.load_state_dict(sd)
        with torch.no_grad():
            each.append(model(batch))
    assert set(out) == {"prediction", "out_features"}
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), ((each[0][k] + each[1][k])
                                               / 2).numpy(),
                                   rtol=1e-6, atol=1e-6)


# --- train step -------------------------------------------------------------

def _fpn_grad(tiny_spec, pool):
    """FPN at ``tiny_spec``: its spec, a batch, the port's state dict from
    numpy JAX trees, and the JAX ((loss, (parts, new batch stats)),
    gradients) of one train-mode forward plus Mix(Dice + BCE), a future
    compiled in ``pool``."""
    batch = _batch(8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jbuild(_cfg("FPN"), spec=tiny_spec, remat=False)
    template = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jb, train=False))
    params, stats = random_trees(template, seed=46)
    crit = _criterion(jlosses)

    def loss_fn(p, s, b):
        out, upd = jm.apply({"params": p, "batch_stats": s}, b, train=True,
                            mutable=["batch_stats"])
        loss, parts = crit(b, out)
        return loss, (parts, upd["batch_stats"])

    lowered = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        params, stats, jb)
    return (ArchSpec(tiny_spec.channels), batch,
            state_dict_from_jax(params, stats),
            pool.submit(_run, lowered, params, stats, jb))


def _port_step(spec, name, sd, batch, kernels=True):
    """One ``make_train_step`` (SGD lr 0.1) of ``name`` from ``sd``: (aux,
    gradients, state dict after the step)."""
    model = build_model(_cfg(name), spec=spec, device="cpu")
    opt = sgd(model.parameters(), 0.1)
    state = create_train_state(model, opt, sd)
    aux = make_train_step(model, opt, _criterion(tlosses), device="cpu")(
        state, batch, kernels=kernels)
    grads = {k: p.grad for k, p in model.named_parameters()}
    return aux, grads, model.state_dict()


def _cos_ratio(a, b):
    a = np.concatenate([np.asarray(v, np.float64).ravel() for v in a])
    b = np.concatenate([np.asarray(v, np.float64).ravel() for v in b])
    return (a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
            np.linalg.norm(a) / np.linalg.norm(b))


def test_fpn_train_step_matches_jax_gradient(zoo):
    spec, batch, sd, ref = zoo[1]["grad"]
    aux, grads, new_sd = _port_step(spec, "FPN", sd, batch)
    (loss, (parts, new_stats)), jgrads = ref.result()
    _close(aux["loss"].numpy(), loss, "loss")
    assert set(aux["parts"]) == set(parts)
    for k, v in aux["parts"].items():
        _close(v.numpy(), parts[k], k)
    want = state_dict_from_jax({}, new_stats)
    assert want and all(k in new_sd for k in want)
    for k, v in want.items():
        _close(new_sd[k].numpy(), v.numpy(), k)
    assert new_sd["resensnet.conv1.0.convBlock.0.1.num_batches_tracked"] == 1
    jg = {k: v for k, v in state_dict_from_jax(jgrads, {}).items()
          if not k.endswith("num_batches_tracked")}
    assert set(jg) == set(grads) and all(g is not None
                                         for g in grads.values())
    cos, ratio = _cos_ratio([grads[k].numpy() for k in jg],
                            [v.numpy() for v in jg.values()])
    assert cos >= 0.9999 and abs(ratio - 1) <= 1e-3, (cos, ratio)


@pytest.mark.parametrize("name", ["FPN2D", "FPNLateFusion"])
def test_train_step_takes_the_segmentation_zoo(tiny_spec, name):
    """``make_train_step`` on the en-face and late-fusion nets at
    ``tiny_spec``: a finite loss, a finite gradient for every parameter,
    one BatchNorm update; the kernels' autograd Functions (their plain
    versions here) and torch's autograd agree (cosine >= 0.9999, norm
    ratio within 1e-3 over all gradients)."""
    spec = ArchSpec(tiny_spec.channels)
    model = build_model(_cfg(name), spec=spec, device="cpu")
    sd = init_state_dict(model, 3)
    batch = _batch(9)
    runs = [_port_step(spec, name, sd, batch, k) for k in (True, False)]
    for aux, grads, new_sd in runs:
        assert np.isfinite(aux["loss"].item())
        assert all(g is not None and torch.isfinite(g).all()
                   for g in grads.values())
        counts = {v.item() for k, v in new_sd.items()
                  if k.endswith("num_batches_tracked")}
        assert counts == {1}
    names = list(runs[0][1])
    cos, ratio = _cos_ratio([runs[0][1][k].numpy() for k in names],
                            [runs[1][1][k].numpy() for k in names])
    assert cos >= 0.9999 and abs(ratio - 1) <= 1e-3, (cos, ratio)
