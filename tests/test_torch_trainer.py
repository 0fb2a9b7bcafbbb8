"""The port's training runtime against the JAX package's, on the CPU.

* ``Trainer`` against JAX's ``Trainer``: FPN2D at ``tiny_spec`` on
  ``tests/test_resume.py``'s ``_Loader`` (16 x 16 SLO), 2 epochs of 2
  steps, Dice and BCE training and validation metrics and a metametric,
  from the same numpy-seeded trees (``state_dict_from_jax``): the final
  weights, BatchNorm stats and momentum at rtol = atol = 1e-5,
  ``curves.json``'s values at 1e-5, the saved epochs and monitor values at
  1e-4.  Both run in float64 (JAX under x64 with every op in float64, the
  port with float64 parameters), as ``tests/test_torch_train.py`` holds
  steps per tensor: in float32 the first step agrees (the same loss, the
  gradients within rounding), but a ReLU input or a max-pool choice within
  rounding of a flip moves a cotangent wholesale, and after a few steps at
  lr 0.1 single BatchNorm biases differ by a large part of their size.  The
  port's pools take the first-max backward here, as every JAX pool off the
  TPU does (XLA's ``reduce_window``): the all-ties backward of its fused
  stages (the TPU kernel's rule) sends a tied window's cotangent to every
  tied input, and these runs meet a tie by their second step.  The JAX
  steps compile at LLVM level 1 (level 0 gives float64 NaN there).
* The epoch tail (``virtual_batch_size`` 3 over 4 batches) through both
  trainers' loops with stub steps, as
  ``tests/test_trainer_loop.py::test_epoch_tail_is_stepped``.
* Resume within the port (``tests/test_resume.py:73-115``): 2 epochs,
  then the third from ``resume.ckpt``, bit-identical to 3 uninterrupted
  epochs (weights, BatchNorm stats, optimizer, step); the early-stopping
  ledger; ``TopKCheckpointer.restore`` and the prune of a crash leftover.
* Dropout under a shared mask: ``jax.random.bernoulli`` (flax's
  ``nn.Dropout``) and the port's ``blocks.dropout_mask`` are both replaced
  by one numpy mask list, in call order, for the slots and nets of the
  former refusal tests (the hybrid's slots 0, 4, 5 and 8, FPN's and
  FPN2D's slot 1): the train-mode forward, the loss, the new running stats
  and the gradient against JAX, in float64 as the trainer (in float32 the
  train-mode forward at these sizes already differs by more than 1e-4 of
  its range: BatchNorms over a few elements).  The hybrid has a distinct rate
  in each of its four slots, so one JAX compile serves its four cases (the
  masks are the function's arguments; a slot's own masks are random, the
  others keep everything); they compile at LLVM level 1, since level 0
  gives the hybrid's gradient NaN.  The port's own masks: 1 - p kept within binomial
  bounds, scaled by 1 / (1 - p), repeated for the same (seed, epoch,
  step), the identity in eval.
"""

import concurrent.futures
import os
import types
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_fusion_fpn_tpu import losses as jlosses
from multimodal_fusion_fpn_tpu.config import make_config as jmake_config
from multimodal_fusion_fpn_tpu.metrics import streaming as JM
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.train import trainer as jtrainer
from multimodal_fusion_fpn_tpu.train.configs import mmetric as jmmetric
from multimodal_fusion_fpn_tpu.train.optim import sgd as jsgd
from multimodal_fusion_fpn_tpu.train.state import TrainState as JState

from multimodal_fusion_fpn_torch import losses as tlosses
from multimodal_fusion_fpn_torch.metrics import streaming as TM
from multimodal_fusion_fpn_torch.models import blocks as tblocks
from multimodal_fusion_fpn_torch.models import encoder3d as tenc
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.train import trainer as ttrainer
from multimodal_fusion_fpn_torch.train.checkpoints import (
    TopKCheckpointer, load_checkpoint, load_training_state, save_checkpoint)
from multimodal_fusion_fpn_torch.train.configs import mmetric
from multimodal_fusion_fpn_torch.train.optim import sgd
from multimodal_fusion_fpn_torch.train.state import create_train_state
from multimodal_fusion_fpn_torch.weights import (init_state_dict,
                                                 state_dict_from_jax)

from test_resume import _Loader
from test_torch_model import jax_template, random_trees
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _cfg(model="FPN2D"):
    return types.SimpleNamespace(model=model, crop="relative_2d_max",
                                 fusion_modality="slo", number_of_outputs=1)


def _compiled_at(make, level):
    """``make`` (a maker of jitted steps) whose steps compile at LLVM
    optimisation ``level``, once per argument structure and shapes."""
    def made(*a, **k):
        jitted = make(*a, **k)
        compiled = {}

        def run(*args):
            key = str(jax.tree.map(
                lambda x: (np.shape(x), str(getattr(x, "dtype", type(x)))),
                args))
            if key not in compiled:
                compiled[key] = jitted.lower(*args).compile(
                    {"xla_backend_optimization_level": level})
            return compiled[key](*args)
        return run
    return made


def _opt_state(tx, params):
    """``tx.init(params)`` as numpy zeros, without an eager JAX call."""
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(tx.init, params))


def _metrics(mod):
    return ({"Dice": mod.Dice(output_key="prediction", target_key="mask"),
             "BCE": mod.BCE(output_key="prediction", target_key="mask",
                            slice=0)},
            {"Dice": mod.Dice(output_key="prediction", target_key="mask"),
             "BCE": mod.BCE(output_key="prediction", target_key="mask",
                            slice=0)})


def _crit(mod):
    return mod.Mix({"d": mod.dice_loss_joint(), "b": mod.bce_loss()})


def _port_trainer(spec, path, sd, epochs, dtype=torch.float32, **kw):
    model = build_model(_cfg(), spec=spec, dtype=dtype, device="cpu")
    if dtype == torch.float64:
        model.double()  # float64 parameters, as the JAX float64 trees
    opt = sgd(model.parameters(), 0.1)
    state = create_train_state(model, opt, sd)
    mt, mv = _metrics(TM)
    tr = ttrainer.Trainer(model, opt, _crit(tlosses), mt, mv,
                          {"Dice": mmetric()}, path, epochs=epochs,
                          save_debug_images=False, device="cpu", **kw)
    return tr, state


@pytest.fixture(scope="module")
def fpn2d_trees(tiny_spec):
    spec = ArchSpec(tiny_spec.channels)
    sd = init_state_dict(build_model(_cfg(), spec=spec, device="cpu"), 0)
    params, stats = random_trees(jax_template(sd), seed=61)
    return spec, params, stats, state_dict_from_jax(params, stats)


def _ckpt_names(path):
    return sorted(f for f in os.listdir(path) if f.startswith("epoch="))


def _name_values(names):
    return [(n.split("-")[0], float(n.split("=")[-1][:-len(".ckpt")]))
            for n in names]


def test_trainer_matches_jax(tmp_path, tiny_spec, fpn2d_trees,
                             monkeypatch):
    spec, params, stats, sd = fpn2d_trees
    # JAX: its Trainer in float64, the steps compiled at level 1
    for name in ("make_train_step", "make_eval_step"):
        monkeypatch.setattr(jtrainer, name,
                            _compiled_at(getattr(jtrainer, name), 1))
    wide = lambda t: jax.tree.map(lambda a: a.astype(np.float64), t)  # noqa
    jpath = str(tmp_path / "jax")
    with jax.enable_x64(True):
        jm = jbuild(jmake_config(model="FPN2D", crop="relative_2d_max",
                                 fusion_modality="slo"), spec=tiny_spec,
                    remat=False, dtype=jnp.float64)
        tx = jsgd(0.1, momentum=0.9, weight_decay=1e-4)
        mt, mv = _metrics(JM)
        jtr = jtrainer.Trainer(jm, tx, _crit(jlosses), mt, mv,
                               {"Dice": jmmetric()}, jpath, epochs=2,
                               save_debug_images=False)
        jstate = JState(step=np.int32(0), params=wide(params),
                        batch_stats=wide(stats),
                        opt_state=_opt_state(tx, wide(params)))
        jfinal = jtr.fit(jstate, _Loader(), _Loader(n_batches=1))

    tpath = str(tmp_path / "torch")
    tr, state = _port_trainer(spec, tpath, sd, 2, dtype=torch.float64)
    pool = tenc.max_pool3d_cl
    monkeypatch.setattr(tenc, "max_pool3d_cl",
                        lambda x, window, first_max=False: pool(x, window,
                                                                True))
    tr.fit(state, _Loader(), _Loader(n_batches=1))

    want = state_dict_from_jax(jax.device_get(jfinal.params),
                               jax.device_get(jfinal.batch_stats))
    got = tr.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert got[k].item() == 4   # 2 epochs x 2 steps
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    trace = jax.device_get(jfinal.opt_state[1].trace)
    mom = state_dict_from_jax(trace, {})
    names = dict(tr.model.named_parameters())
    for k, v in mom.items():
        if k.endswith("num_batches_tracked"):
            continue
        buf = tr.optimizer.state[names[k]]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert state.step == int(jfinal.step) == 4

    import json
    with open(join(jpath, "curves.json")) as f:
        jcurves = json.load(f)
    with open(join(tpath, "curves.json")) as f:
        tcurves = json.load(f)
    assert list(tcurves) == list(jcurves) == [
        "Dice (train)", "BCE (train)", "Dice (val)", "BCE (val)"]
    for k in jcurves:
        np.testing.assert_allclose(tcurves[k], jcurves[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    jn, tn = _ckpt_names(jpath), _ckpt_names(tpath)
    assert len(jn) == len(tn) == 2
    for (te, tv), (je, jv) in zip(_name_values(tn), _name_values(jn)):
        assert te == je and abs(tv - jv) <= 1e-4
    assert not os.path.exists(join(tpath, "images")) or not os.listdir(
        join(tpath, "images"))


class _StubLoader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def _stub_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"slo": rng.normal(size=(b, 1, 16, 1, 16)).astype(np.float32),
            "mask": (rng.random((b, 1, 16, 1, 16)) > 0.5).astype(
                np.float32)}


def test_epoch_tail_is_stepped(tmp_path, tiny_spec):
    """4 batches at virtual_batch_size 3: one step of 3 micro-batches and
    one tail step of 1, in both trainers (stub steps record the calls)."""
    loader = _StubLoader([_stub_batch(i) for i in range(4)])
    calls = {"jax": [], "torch": []}

    jtr = jtrainer.Trainer(
        jbuild(jmake_config(model="FPN2D", crop="relative_2d_max",
                            fusion_modality="slo"), spec=tiny_spec,
               remat=False),
        jsgd(0.1), _crit(jlosses), {}, {}, {}, str(tmp_path / "j"),
        epochs=1, save_debug_images=False, virtual_batch_size=3)

    def jstub(n):
        def step(state, payload, rng):
            calls["jax"].append((n, payload["slo"].shape[0] if n > 1
                                 else None))
            return state, {"loss": 0.0, "parts": {}, "metrics": {}}
        return step

    jtr.train_step = jstub(3)
    jtr._tail_steps = {3: jtr.train_step}
    jtr._make_step = jstub
    jtr._train_epoch(state=object(), loader=loader, epoch=0)

    tr, state = _port_trainer(ArchSpec(tiny_spec.channels),
                              str(tmp_path / "t"), None, 1,
                              virtual_batch_size=3)

    def tstub(n):
        def step(state, payload, kernels=True, generator=None):
            calls["torch"].append((n, payload["slo"].shape[0] if n > 1
                                   else None))
            return {"loss": torch.zeros(()), "parts": {}, "metrics": {}}
        return step

    tr.train_step = tstub(3)
    tr._tail_steps = {3: tr.train_step}
    tr._make_step = tstub
    tr._train_epoch(state, loader, 0)
    assert calls["torch"] == calls["jax"] == [(3, 3), (1, None)]
    assert tr.steps == 2 and tr.images == 8


def _leaves(tr, state):
    sd = {k: v.clone() for k, v in tr.model.state_dict().items()}
    mom = [tr.optimizer.state[p]["momentum_buffer"].clone()
           for p in tr.model.parameters()]
    return sd, mom, state.step


def test_resume_bit_identical(tmp_path, tiny_spec, fpn2d_trees):
    spec, _, _, sd = fpn2d_trees
    tr_a, st_a = _port_trainer(spec, str(tmp_path / "a"), sd, 3)
    tr_a.fit(st_a, _Loader(), _Loader(n_batches=1))

    path_b = str(tmp_path / "b")
    tr_b, st_b = _port_trainer(spec, path_b, sd, 2)
    tr_b.fit(st_b, _Loader(), _Loader(n_batches=1))
    mid = _leaves(tr_b, st_b)
    resume = join(path_b, "resume.ckpt")
    extra = load_training_state(resume)
    assert extra["next_epoch"] == 2 and extra["step"] == 4

    tr_c, st_c = _port_trainer(spec, path_b, sd, 3)
    tr_c.model.load_state_dict(load_checkpoint(resume,
                                               tr_c.model.state_dict()))
    tr_c.optimizer.load_state_dict(extra["optimizer"])
    st_c.step = extra["step"]
    tr_c.fit(st_c, _Loader(), _Loader(n_batches=1),
             start_epoch=extra["next_epoch"])

    a, c = _leaves(tr_a, st_a), _leaves(tr_c, st_c)
    assert sorted(a[0]) == sorted(c[0])
    for k in a[0]:
        assert torch.equal(a[0][k], c[0][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a[1], c[1]))
    assert a[2] == c[2] == 6
    assert any(not torch.equal(a[0][k], mid[0][k]) for k in a[0])
    # the curves carry the first two epochs over, then the third
    import json
    with open(join(str(tmp_path / "a"), "curves.json")) as f:
        ca = json.load(f)
    with open(join(path_b, "curves.json")) as f:
        cc = json.load(f)
    assert ca == cc and len(ca["Dice (val)"]) == 3


def test_resume_restores_early_stopping_ledger(tmp_path, tiny_spec,
                                               fpn2d_trees):
    spec, _, _, sd = fpn2d_trees
    path = str(tmp_path / "e")
    tr, st = _port_trainer(spec, path, sd, 1, early_stopping=3)
    tr.fit(st, _Loader(), _Loader(n_batches=1))
    extra = load_training_state(join(path, "resume.ckpt"))
    assert extra["next_epoch"] == 1 and extra["patience_left"] == 3
    assert np.isfinite(extra["best"])
    # a resumed trainer continues the ledger: no improvement for 3 epochs
    # after best = 2.0 stops it
    tr2, st2 = _port_trainer(spec, path, sd, 10, early_stopping=3)
    tr2._train_epoch = lambda state, loader, epoch: None
    tr2._val_epoch = lambda state, loader: {"Dice": 0.5, "BCE": 0.1}
    seen = []
    tr2._save_resume = lambda state, epoch, best, pl: seen.append(
        (epoch, best, pl))
    tr2.fit(st2, _Loader(), _Loader(), start_epoch=1,
            early_state={"best": 2.0, "patience_left": 3})
    assert seen == [(1, 2.0, 2), (2, 2.0, 1)]


def test_topk_restore_rebuilds_ledger(tmp_path):
    d = str(tmp_path / "ck")
    sd = {"w": torch.zeros(1)}
    ck = TopKCheckpointer(d, monitor="Dice", mode="max", save_top_k=2)
    for epoch, v in [(0, 0.5), (1, 0.7), (2, 0.6), (3, float("nan"))]:
        ck.update(epoch, v, sd)
    assert sorted(os.listdir(d)) == ["epoch=1-Dice=0.7000.ckpt",
                                     "epoch=2-Dice=0.6000.ckpt"]
    ck2 = TopKCheckpointer(d, monitor="Dice", mode="max", save_top_k=2)
    assert ck2.restore() == 2
    assert sorted(v for v, _ in ck2.saved) == sorted(v for v, _ in ck.saved)
    ck2.update(4, 0.9, sd)
    assert len(ck2.saved) == 2 and max(v for v, _ in ck2.saved) == 0.9
    assert load_checkpoint(join(d, "epoch=4-Dice=0.9000.ckpt")).keys() == \
        {"w"}
    # mode "min" keeps the smallest
    ck3 = TopKCheckpointer(str(tmp_path / "min"), monitor="BCE",
                           mode="min", save_top_k=1)
    for epoch, v in [(0, 0.5), (1, 0.7), (2, 0.2)]:
        ck3.update(epoch, v, sd)
    assert [v for v, _ in ck3.saved] == [0.2]


def test_topk_restore_prunes_crash_leftover(tmp_path):
    d = str(tmp_path / "ck")
    sd = {"w": torch.zeros(1)}
    ck = TopKCheckpointer(d, monitor="Dice", mode="max", save_top_k=2)
    for epoch, v in [(0, 0.5), (1, 0.7)]:
        ck.update(epoch, v, sd)
    # the crash window: a third (better) file, the worst never removed
    save_checkpoint(join(d, "epoch=2-Dice=0.9000.ckpt"), sd)
    ck2 = TopKCheckpointer(d, monitor="Dice", mode="max", save_top_k=2)
    assert ck2.restore() == 2
    assert sorted(v for v, _ in ck2.saved) == [0.7, 0.9]
    files = sorted(os.listdir(d))
    assert len(files) == 2 and "epoch=0-Dice=0.5000.ckpt" not in files


# --- dropout ----------------------------------------------------------------

# at LLVM level 0 (``compile_ref``) the hybrid's gradient comes out NaN
LEVEL_1 = {"xla_backend_optimization_level": 1}
# the hybrid's rate per slot: distinct, so a mask's keep probability names
# its slot
HYBRID_RATES = {0: 0.1, 4: 0.2, 5: 0.3, 8: 0.4}
SINGLE_RATE = {1: 0.25}


def _batch(seed, b=1, y=8, d=64, w=32, eh=80):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(b, 1, y, d, w)).astype(np.float32),
            "slo": rng.normal(size=(b, 1, eh, 1, w)).astype(np.float32),
            "mask": (rng.random((b, 1, y, 1, w)) > 0.7).astype(np.float32)}


def _spec(channels, rates):
    return ArchSpec(channels, dropout=tuple(rates.get(i, 0.0)
                                            for i in range(9)))


def _port_calls(name, spec, sd, batch):
    """The (number of elements, keep probability) of each dropout mask of
    the port's train-mode forward, in call order (every element kept)."""
    model = build_model(_cfg(name), spec=spec, device="cpu")
    model.load_state_dict(sd)
    model.train()
    calls = []

    def record(shape, keep_prob, generator):
        calls.append((int(np.prod(shape)), round(keep_prob, 9)))
        return torch.ones(shape, dtype=torch.bool)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tblocks, "dropout_mask", record)
        with tblocks.dropout_generator(torch.Generator()):
            model({k: torch.from_numpy(v) for k, v in batch.items()})
    return calls


def _jax_grad_fn(jm, crit, calls):
    """value_and_grad of the train-mode forward plus the loss, the masks
    one flat argument: each ``jax.random.bernoulli`` call takes the next
    elements, its (shape, keep probability) appended to ``calls`` while
    the function is traced."""
    def loss_fn(p, s, b, flat):
        at = 0

        def bernoulli(key, p=0.5, shape=None):
            nonlocal at
            n = int(np.prod(shape))
            calls.append((tuple(shape), float(p)))
            at += n
            return flat[at - n:at].reshape(shape)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "bernoulli", bernoulli)
            out, upd = jm.apply({"params": p, "batch_stats": s}, b,
                                train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        assert at == flat.shape[0], (at, flat.shape)
        loss, parts = crit(b, out)
        return loss, (parts, upd["batch_stats"], out["prediction"])
    return jax.value_and_grad(loss_fn, has_aux=True)


def _masks(calls, slot_keep, seed):
    """numpy masks for ``calls``: Bernoulli(keep) where the keep
    probability is ``slot_keep``'s, all kept elsewhere."""
    rng = np.random.default_rng(seed)
    return [rng.random(shape) < keep if abs(keep - slot_keep) < 1e-9
            else np.ones(shape, bool) for shape, keep in calls]


def _flat(masks):
    return np.concatenate([m.ravel() for m in masks])


@pytest.fixture(scope="module")
def dropout_refs(tiny_spec):
    """Per net (hybrid, FPN, FPN2D): its spec, batch, float64 JAX trees,
    the port's state dict, the mask calls, and the compiled float64 JAX
    value_and_grad (traced here, compiled side by side in threads)."""
    nets = {"FPNHybridFusion": HYBRID_RATES, "FPN": SINGLE_RATE,
            "FPN2D": SINGLE_RATE}
    out, lowered = {}, {}
    crit = _crit(jlosses)
    for i, (name, rates) in enumerate(nets.items()):
        spec = _spec(tiny_spec.channels, rates)
        sd0 = init_state_dict(build_model(_cfg(name), spec=spec,
                                          device="cpu"), 0)
        params, stats = (_wide(t) for t in random_trees(jax_template(sd0),
                                                        seed=70 + i))
        batch = _batch(80 + i)
        sd = state_dict_from_jax(params, stats)
        port_calls = _port_calls(name, spec, sd, batch)
        calls = []
        with jax.enable_x64(True):
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            jm = jbuild(jmake_config(model=name, crop="relative_2d_max",
                                     fusion_modality="slo"), spec=spec,
                        remat=False, dtype=jnp.float64)
            flat = np.ones(sum(n for n, _ in port_calls), bool)
            lowered[name] = jax.jit(_jax_grad_fn(jm, crit, calls)).lower(
                params, stats, jb, flat)
        # the JAX trace drew its masks in the port's order, each of the
        # port's size and keep probability
        assert [(int(np.prod(s)), round(k, 9)) for s, k in calls] == \
            port_calls
        assert sorted({k for _, k in calls}) == sorted(
            {round(1 - r, 9) for r in rates.values()})
        out[name] = dict(spec=spec, batch=batch, jb=jb, params=params,
                         stats=stats, sd=sd, calls=calls, rates=rates)
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        futures = {n: pool.submit(lo.compile, LEVEL_1)
                   for n, lo in lowered.items()}
        for n, f in futures.items():
            out[n]["fn"] = f.result()
    return out


def _wide(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _cos_ratio(a, b):
    a = np.concatenate([np.asarray(v, np.float64).ravel() for v in a])
    b = np.concatenate([np.asarray(v, np.float64).ravel() for v in b])
    return (a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
            np.linalg.norm(a) / np.linalg.norm(b))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                  1e-30), what


@pytest.mark.parametrize("name,slot", [
    ("FPNHybridFusion", 0), ("FPNHybridFusion", 4), ("FPNHybridFusion", 5),
    ("FPNHybridFusion", 8), ("FPN", 1), ("FPN2D", 1)])
def test_dropout_matches_jax_under_a_shared_mask(dropout_refs, name, slot):
    """One train-mode forward and backward with dropout in ``slot`` (its
    masks random, shared by both packages): the prediction, the loss and
    its parts and the new running stats to 1e-4 * max|ref|, the gradients
    as a whole (cosine >= 0.9999, norm ratio within 1e-3), as
    ``tests/test_torch_zoo.py`` holds FPN's step; the dropout changed the
    prediction."""
    ref = dropout_refs[name]
    keep = 1.0 - ref["rates"][slot]
    masks = _masks(ref["calls"], keep, 100 + slot)
    assert any(not m.all() for m in masks)
    with jax.enable_x64(True):
        (loss, (parts, new_stats, pred)), jgrads = ref["fn"](
            ref["params"], ref["stats"], ref["jb"], _flat(masks))

    model = build_model(_cfg(name), spec=ref["spec"], dtype=torch.float64,
                        device="cpu").double()
    model.load_state_dict(ref["sd"])
    model.train()
    it = iter(masks)
    seen = []

    def shared(shape, keep_prob, generator):
        m = next(it)
        seen.append(keep_prob)
        assert m.size == int(np.prod(shape))
        return torch.from_numpy(m.reshape(shape))

    b = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tblocks, "dropout_mask", shared)
        with tblocks.dropout_generator(torch.Generator()):
            out = model(b)
    tloss, tparts = _crit(tlosses)(b, out)
    tloss.backward()
    assert next(it, None) is None
    assert [round(k, 9) for k in seen] == [round(k, 9)
                                           for _, k in ref["calls"]]

    _close(out["prediction"].detach().numpy(), pred, "prediction")
    _close(tloss.item(), loss, "loss")
    for k, v in tparts.items():
        _close(v.item(), parts[k], k)
    want = state_dict_from_jax({}, jax.device_get(new_stats))
    sd = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            _close(sd[k].numpy(), v.numpy(), k)
    jg = {k: v for k, v in state_dict_from_jax(jax.device_get(jgrads),
                                               {}).items()
          if not k.endswith("num_batches_tracked")}
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(jg) == set(grads) and all(g is not None
                                         for g in grads.values())
    bad_t = [k for k, g in grads.items() if not torch.isfinite(g).all()]
    bad_j = [k for k, g in jg.items() if not torch.isfinite(g).all()]
    assert not bad_t and not bad_j, (bad_t[:5], bad_j[:5])
    cos, ratio = _cos_ratio([grads[k].numpy() for k in jg],
                            [v.numpy() for v in jg.values()])
    assert cos >= 0.9999 and abs(ratio - 1) <= 1e-3, (cos, ratio)
    model.eval()
    with torch.no_grad():
        plain = model(b)["prediction"]
    assert not torch.allclose(plain, out["prediction"].detach(), atol=1e-3)


def test_port_dropout_masks():
    """The port's own masks: about 1 - p of the elements kept (within 5
    standard deviations of the binomial), the kept ones scaled by
    1 / (1 - p), the same masks for the same (seed, epoch, step) and
    others for another step, the identity in eval and at p = 0, and a
    training forward without a generator refused."""
    p, n = 0.3, 200_000
    x = torch.full((4, n // 4), 2.0)

    def drop(epoch, step, training=True, rate=p):
        gen = torch.Generator().manual_seed(
            ttrainer.step_seed(1234, epoch, step))
        with tblocks.dropout_generator(gen):
            return tblocks.dropout(x, rate, training)

    y = drop(0, 0)
    kept = (y != 0).sum().item()
    sd = np.sqrt(n * p * (1 - p))
    assert abs(kept - n * (1 - p)) <= 5 * sd, kept
    assert torch.allclose(y[y != 0], torch.tensor(2.0 / (1 - p)))
    assert torch.equal(y, drop(0, 0))
    assert not torch.equal(y, drop(0, 1))
    assert not torch.equal(y, drop(1, 0))
    assert drop(0, 0, training=False) is x
    assert drop(0, 0, rate=0.0) is x
    with pytest.raises(RuntimeError, match="generator"):
        tblocks.dropout(x, p, True)
