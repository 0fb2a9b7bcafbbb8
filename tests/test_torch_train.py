"""The port's train step against the JAX package's, on the CPU.

One ``make_train_step`` of FPNHybridFusion (ini widths 16/32/64/128/256,
so stages 1-3 take the fused-conv route with its stats epilogue) on the
small batch of ``tests/test_full_model_parity.py`` (b=1, y=8, d=64,
w=32), with the JAX blocks in fused mode "on" (the fused chain through
the XLA reference).  Same numpy weights (seeded, BatchNorm running stats
perturbed) and batches through both; ``sgd(0.1)`` (momentum 0.9, weight
decay 1e-4) and ``Mix(Dice + BCE)``.  Each JAX step is built and run once
for the module, and every reference serves all the tests whose inputs it
shares: tracing and compiling a JAX train step takes tens of seconds on
the CPU, running it under one.  The module's first test traces the JAX
step functions one after another while threads compile and run them,
then makes every port run the tests read while the last compiles finish
(a trace holds the GIL: traced beside the port runs, both ran several
times slower; XLA's compiles release it).  Each test then waits for the
JAX references it reads.  XLA's CPU compile spends most of its time in
LLVM, so each reference compiles at a reduced LLVM optimisation level
(``LEVELS``).

Tolerances.  Both sides compute in float64 (the JAX fused convs and their
BatchNorm sums still run in float32 inside), and the loss, its parts, the
metrics, every gradient, the new running stats and the updated parameters
are held per tensor to max-abs-err <= 1e-4 * max|ref| + 2 * s, after two
steps (so the momentum buffer is used) and after one ``accum_steps=2``
step.  ``s`` is what float32 leaves undetermined: the spread between the
port's own fp32 and fp64 runs of the same step on the same tensor.  It is
not small here: a relu mask or a max-pool choice that flips under a 1e-7
change of its input moves a cotangent wholesale, the deep BatchNorms
average over as few as 4 elements, and E[y^2] - E[y]^2 in fp32 loses a
nearly constant channel's variance against eps.  The port's fp32 and
fp64 gradients differ by up to 20% on single tensors of the first step;
after one SGD step at lr 0.1 most tensors differ by more than 1e-4.  fp32
is held to the fp64 reference on what the forward determines (loss,
parts, metrics, running stats: 1e-4 per tensor) and on the gradients as a
whole (cosine >= 0.9999, norm ratio within 1e-3).

A second reference has the JAX blocks in fused mode "off", where every op
runs in float64: the port's fp64 step (with fp64 parameters) meets it at
1e-4 * max|ref| per tensor with no slack.  It is also the reference of the
``accum_steps=2`` step in both comparisons: the two modes differ only
inside the fused convs, which the single steps hold.  A bf16 step is held
against the JAX package's own distance from bf16 to the higher-precision
step.
"""

import collections
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_fusion_fpn_tpu import losses as jlosses
from multimodal_fusion_fpn_tpu.config import make_config
from multimodal_fusion_fpn_tpu.metrics import device as jmetrics
from multimodal_fusion_fpn_tpu.models import blocks as jblocks
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.train import optim as joptim
from multimodal_fusion_fpn_tpu.train.state import TrainState as JState
from multimodal_fusion_fpn_tpu.train.step import make_train_step as jstep

from multimodal_fusion_fpn_torch import losses as tlosses
from multimodal_fusion_fpn_torch.metrics import device as tmetrics
from multimodal_fusion_fpn_torch.models import blocks as tblocks
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.train.optim import sgd
from multimodal_fusion_fpn_torch.train.state import create_train_state
from multimodal_fusion_fpn_torch.train.step import make_train_step
from multimodal_fusion_fpn_torch.weights import state_dict_from_jax

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 0.1
# The LLVM optimisation level each JAX step compiles at, by float64.
# Level 0 halves a step's compile time but gives the float64 steps a NaN
# second step; level 1 takes 13-28% off their compile time and agrees
# with the default level to 4e-12 relative in fused mode "off" and to
# 4e-4 in mode "on", whose float32 convs leave its second step that
# undetermined (the tests' slack, module note).  The bf16 step at level 0
# sits where it sits at the default level (cosine 0.4013 to the float64
# step either way).
LEVELS = {True: 1, False: 0}


def _cfg():
    return make_config(model="FPNHybridFusion", crop="relative_2d_max",
                       fusion_modality="slo")


def _batch(seed, b=1, y=8, d=64, w=32):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(b, 1, y, d, w)).astype(np.float32),
            "slo": rng.normal(size=(b, 1, 80, 1, w)).astype(np.float32),
            "mask": (rng.random((b, 1, y, 1, w)) > 0.7).astype(np.float32)}


def _criterion(mod):
    return mod.Mix({"Dice Loss": mod.dice_loss_joint(),
                    "BCE loss": mod.bce_loss()})


def _random_trees(template, seed):
    """numpy (params, batch_stats): conv kernels ~ N(0, 1/fan_in), BN scale
    ~ N(1, 0.1), biases ~ N(0, 0.1), running mean ~ N(0, 0.5), running var
    ~ U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(size=a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "scale":
            v = rng.normal(1.0, 0.1, size=a.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.1 if name == "bias" else 0.5, size=a.shape)
        else:
            v = rng.uniform(0.5, 2.0, size=a.shape)
        return np.asarray(v, np.float32)

    return (jax.tree_util.tree_map_with_path(leaf, template["params"]),
            jax.tree_util.tree_map_with_path(leaf, template["batch_stats"]))


def _recording_sgd():
    """``sgd(LR)`` whose state also keeps the last gradients it was given,
    so the jitted JAX step hands them back."""
    base = joptim.sgd(LR)

    def update(g, s, p=None):
        u, inner = base.update(g, s[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(
        lambda p: (base.init(p), jax.tree.map(jnp.zeros_like, p)), update)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights():
    """The module's numpy (params, batch_stats) in the JAX tree layout
    (``_random_trees``, seed 3) and its two batches."""
    b0, b1 = _batch(0), _batch(1)
    model = jbuild(_cfg(), remat=False)
    template = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in b0.items()}, train=False))
    return _random_trees(template, seed=3), (b0, b1)


def _jax_steps(weights, mode, dtype=jnp.float64, accum_steps=1):
    """Trace one JAX train step function, with the package's blocks in
    fused mode ``mode``, from ``weights``; returns ``finish()``, which
    compiles it and returns its runs: with ``accum_steps`` 1 two steps
    ('step1', 'step2'; one below float64), with 2 one accum_steps=2 step
    over both batches ('accum').  float64 runs under x64 (a per-thread
    setting).  The step compiles at its level of ``LEVELS``."""
    x64 = dtype == jnp.float64
    (params, stats), (b0, b1) = weights
    wide = np.float64 if x64 else np.float32
    cast = lambda t: jax.tree.map(lambda a: a.astype(wide), t)
    key = jax.random.PRNGKey(1)
    if accum_steps == 2:
        batches = [("accum", cast({k: np.stack([b0[k], b1[k]])
                                   for k in b0}))]
    else:
        batches = [("step1", cast(b0))] + ([("step2", cast(b1))]
                                           if x64 else [])
    prev = jblocks._FUSED_MODE
    jblocks.set_fused_stage_mode(mode)
    try:
        with jax.enable_x64(x64):
            tx = _recording_sgd()
            # the optimizer's zero state in numpy: run eagerly, its
            # zeros_like compiled one small program per parameter shape
            opt0 = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                jax.eval_shape(tx.init, cast(params)))
            state0 = JState(step=jnp.asarray(0), params=cast(params),
                            batch_stats=cast(stats), opt_state=opt0)
            model = jbuild(_cfg(), remat=False, dtype=dtype)
            lowered = jstep(model, tx, _criterion(jlosses),
                            accum_steps=accum_steps, donate=False).lower(
                                state0, batches[0][1], key)
    finally:
        jblocks.set_fused_stage_mode(prev)

    def finish():
        with jax.enable_x64(x64):
            step = lowered.compile(
                {"xla_backend_optimization_level": LEVELS[x64]})
            out, state = {}, state0
            for name, batch in batches:
                state, aux = step(state, batch, key)
                out[name] = dict(params=_np(state.params),
                                 stats=_np(state.batch_stats),
                                 grads=_np(state.opt_state[1]),
                                 aux=_np(aux))
        return out
    return finish


@pytest.fixture(scope="module")
def runs():
    """The module's weights, its JAX references and the port's runs: the
    JAX step functions traced one after another (the fused mode is a
    global of the JAX package) while threads compile and run them, then
    the port's runs (module note)."""
    weights = _weights()
    compiler = concurrent.futures.ThreadPoolExecutor(2)
    jobs = {"weights": weights}
    try:
        for name, args in (("off_accum", ("off", jnp.float64, 2)),
                           ("bf16", ("on", jnp.bfloat16)),
                           ("off", ("off",)), ("on", ("on",))):
            jobs[name] = compiler.submit(_jax_steps(weights, *args))
        for kernels, dtype, group, n in PORT_RUNS:
            jobs.update(_port_runs(weights, kernels, dtype, group, n))
        yield jobs
    finally:
        compiler.shutdown(cancel_futures=True)


@pytest.fixture(scope="module")
def jax_run(runs):
    """Fused mode 'on' (the fused chain through the XLA reference; its
    convs and BatchNorm sums run in float32 inside): two steps."""
    return runs["on"].result()


@pytest.fixture(scope="module")
def jax_xla_run(runs):
    """Fused mode 'off': every op of the JAX step in float64 XLA; two
    steps and the accum_steps=2 step."""
    return {**runs["off"].result(), **runs["off_accum"].result()}


def _port_runs(weights, kernels, dtype, group, n):
    """The port's runs from ``weights``, keyed (kernels, dtype, name):
    ``group`` 'steps', the first ``n`` of two train steps ('steps1',
    'steps2'), or 'accum', one accum_steps=2 step over both batches
    ('accum1').  On the CPU both ``kernels`` take the plain versions: True
    through the kernels' autograd Functions, False through torch's
    autograd."""
    (params, stats), (b0, b1) = weights
    batches = ([{k: np.stack([b0[k], b1[k]]) for k in b0}]
               if group == "accum" else [b0, b1][:n])
    model = build_model(_cfg(), dtype=dtype, device="cpu")
    if dtype == torch.float64:
        model.double()  # fp64 parameters, as the JAX fp64 trees
    opt = sgd(model.parameters(), LR)
    state = create_train_state(model, opt, state_dict_from_jax(params, stats))
    step = make_train_step(model, opt, _criterion(tlosses),
                           accum_steps=2 if group == "accum" else 1,
                           device="cpu")
    out = {}
    for i, b in enumerate(batches):
        aux = step(state, b, kernels=kernels)
        out[(kernels, dtype, f"{group}{i + 1}")] = dict(
            aux=aux, step=state.step,
            grads={k: p.grad.clone() for k, p in model.named_parameters()},
            sd={k: v.clone() for k, v in model.state_dict().items()})
    return out


# The port's runs the tests read: (kernels, dtype, group, steps)
PORT_RUNS = [(k, dt, g, 2) for g in ("steps", "accum")
             for k in (True, False)
             for dt in (torch.float64, torch.float32)] + [
    (k, torch.bfloat16, "steps", 1) for k in (True, False)]


def port_run(runs, kernels, name, dtype=torch.float64):
    """The port's run ``name`` ('steps1', 'steps2' or 'accum1',
    :func:`_port_runs`) from the module's weights."""
    return runs[(kernels, dtype, name)]


def assert_rel(got, ref, what, slack=0.0):
    """max|got - ref| <= 1e-4 * max|ref| + slack."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max(initial=0.0)
    peak = np.abs(ref).max(initial=0.0)
    assert err <= 1e-4 * peak + slack or err == 0.0, (what, err, peak, slack)


def _spread(a, b):
    """max|a - b| over matching tensors of two dicts (numpy-able values)."""
    return {k: float(np.abs(np.asarray(v, np.float64)
                            - np.asarray(b[k], np.float64)).max(initial=0.0))
            for k, v in a.items()}


def indeterminacy(runs, kernels, name):
    """What the fp32 precision leaves open, per quantity: 2 x the port's own
    fp32-vs-fp64 spread for run ``name`` (module note)."""
    r64 = port_run(runs, kernels, name)
    r32 = port_run(runs, kernels, name, torch.float32)
    flat = lambda r: {"loss": r["aux"]["loss"].numpy(),
                      **{k: v.numpy() for k, v in r["aux"]["parts"].items()},
                      **{k: v.numpy() for k, v in r["aux"]["metrics"].items()},
                      **{k: v.numpy() for k, v in r["grads"].items()},
                      **{"sd." + k: v.numpy() for k, v in r["sd"].items()}}
    return {k: 2.0 * v for k, v in _spread(flat(r32), flat(r64)).items()}


def _check_state(got, ref, slack):
    """Parameters and running stats of the port's state dict against the
    JAX trees."""
    want = state_dict_from_jax(ref["params"], ref["stats"])
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert_rel(got[k].numpy(), v.numpy(), k, slack["sd." + k])


def _check_grads(got, ref, slack):
    want = state_dict_from_jax(ref["grads"], {})
    assert set(got) <= set(want)
    for k, v in got.items():
        assert_rel(v.numpy(), want[k].numpy(), k, slack[k])


def _check_aux(got, ref, slack):
    assert_rel(got["loss"].numpy(), ref["aux"]["loss"], "loss",
               slack["loss"])
    assert set(got["parts"]) == set(ref["aux"]["parts"])
    for k, v in got["parts"].items():
        assert_rel(v.numpy(), ref["aux"]["parts"][k], k, slack[k])
    assert set(got["metrics"]) == set(ref["aux"]["metrics"]) == {"Dice",
                                                                  "BCE"}
    for k, v in got["metrics"].items():
        assert_rel(v.numpy(), ref["aux"]["metrics"][k], k, slack[k])


KERNELS = pytest.mark.parametrize("kernels", [True, False],
                                  ids=["functions", "autograd"])


@KERNELS
@pytest.mark.parametrize("step", ["step1", "step2"])
def test_loss_parts_and_metrics_match_jax(runs, jax_run, kernels, step):
    name = f"steps{step[-1]}"
    _check_aux(port_run(runs, kernels, name)["aux"], jax_run[step],
               indeterminacy(runs, kernels, name))


@KERNELS
@pytest.mark.parametrize("step", ["step1", "step2"])
def test_every_gradient_matches_jax(runs, jax_run, kernels, step):
    name = f"steps{step[-1]}"
    _check_grads(port_run(runs, kernels, name)["grads"], jax_run[step],
                 indeterminacy(runs, kernels, name))


@KERNELS
@pytest.mark.parametrize("step", ["step1", "step2"])
def test_params_and_running_stats_match_jax(runs, jax_run, kernels,
                                            step):
    """Updated parameters (SGD with momentum from the second step on) and
    the BatchNorm running stats (momentum 0.1, unbiased var)."""
    name = f"steps{step[-1]}"
    run = port_run(runs, kernels, name)
    _check_state(run["sd"], jax_run[step],
                 indeterminacy(runs, kernels, name))
    n = int(step[-1])
    assert run["step"] == n
    counts = [v.item() for k, v in run["sd"].items()
              if k.endswith("num_batches_tracked")]
    assert counts and all(c == n for c in counts)


@KERNELS
def test_accum_steps_2_matches_jax(runs, jax_xla_run, kernels):
    """Gradients averaged over two micro-batches from the same parameters,
    BatchNorm stats updated once per micro-batch, one optimizer step (the
    JAX accum step of ``jax_xla_run``, module note)."""
    run = port_run(runs, kernels, "accum1")
    ref = jax_xla_run["accum"]
    slack = indeterminacy(runs, kernels, "accum1")
    _check_aux(run["aux"], ref, slack)
    assert run["aux"]["metrics"]["Dice"].shape == (2,)
    _check_grads(run["grads"], ref, slack)
    _check_state(run["sd"], ref, slack)
    counts = {v.item() for k, v in run["sd"].items()
              if k.endswith("num_batches_tracked")}
    assert counts == {2}


@KERNELS
def test_fp32_step_matches_jax(runs, jax_run, kernels):
    """fp32 against the fp64 reference (module note): what the forward
    determines per tensor, the gradients as a whole."""
    run = port_run(runs, kernels, "steps1", torch.float32)
    ref = jax_run["step1"]
    _check_aux(run["aux"], ref, collections.defaultdict(float))
    want = state_dict_from_jax(ref["params"], ref["stats"])
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert_rel(run["sd"][k].numpy(), v.numpy(), k)
    grads = state_dict_from_jax(ref["grads"], {})
    got = np.concatenate([v.numpy().ravel() for v in run["grads"].values()])
    want = np.concatenate([grads[k].numpy().ravel() for k in run["grads"]])
    got, want = got.astype(np.float64), want.astype(np.float64)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    ratio = np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 0.9999 and abs(ratio - 1) <= 1e-3, (cos, ratio)


@KERNELS
@pytest.mark.parametrize("run", ["step1", "step2", "accum"])
def test_fp64_step_matches_jax_xla_per_tensor(runs, jax_xla_run, kernels,
                                              run):
    """Against the JAX step in fused mode 'off', where every op runs in
    float64: the loss, parts, metrics, every gradient, the new running
    stats and the updated parameters at 1e-4 * max|ref| per tensor, with
    no slack."""
    got = port_run(runs, kernels,
                   {"step1": "steps1", "step2": "steps2",
                    "accum": "accum1"}[run])
    exact = collections.defaultdict(float)
    _check_aux(got["aux"], jax_xla_run[run], exact)
    _check_grads(got["grads"], jax_xla_run[run], exact)
    _check_state(got["sd"], jax_xla_run[run], exact)


@pytest.fixture(scope="module")
def bf16_run(runs):
    """One step of the JAX package (fused mode 'on') in bf16, from the
    weights and batch of ``jax_run``."""
    return runs["bf16"].result()


@KERNELS
def test_bf16_step_sits_as_far_from_fp32_as_jax(runs, jax_run, bf16_run,
                                               kernels):
    """At these random weights a bf16 step's gradients are mostly rounding
    noise: the BatchNorm backward cancels the large mean and linear parts
    of each cotangent, and relu masks of near-zero pre-activations flip.
    The JAX package's own bf16 step sits at a cosine of about 0.4 from its
    higher-precision step (the fp64 step of ``jax_run``, which shares the
    inputs; fp32 sits at a cosine above 0.9999 from it).  The port's bf16
    step must sit no farther from the port's fp64 step (cosine within 0.05
    of JAX's, norm ratio within 5% of JAX's), with the bf16 loss within
    1e-2 of JAX's."""
    port = {dt: port_run(runs, kernels, "steps1", dt)
            for dt in (torch.bfloat16, torch.float64)}
    loss16 = float(port[torch.bfloat16]["aux"]["loss"].float())
    jloss16 = float(bf16_run["step1"]["aux"]["loss"])
    assert abs(loss16 - jloss16) <= 1e-2 * abs(jloss16), (loss16, jloss16)
    names = list(port[torch.float64]["grads"])
    flat = lambda g: np.concatenate([np.asarray(g[k], np.float64).ravel()
                                     for k in names])
    jgrads = {dt: state_dict_from_jax(r["step1"]["grads"], {})
              for dt, r in ((jnp.bfloat16, bf16_run),
                            (jnp.float64, jax_run))}
    def cos_ratio(a, b):
        a, b = flat(a), flat(b)
        return (a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
                np.linalg.norm(a) / np.linalg.norm(b))
    j_cos, j_ratio = cos_ratio({k: v.numpy() for k, v in
                                jgrads[jnp.bfloat16].items()},
                               {k: v.numpy() for k, v in
                                jgrads[jnp.float64].items()})
    p_cos, p_ratio = cos_ratio(
        {k: v.float().numpy() for k, v in
         port[torch.bfloat16]["grads"].items()},
        {k: v.numpy() for k, v in port[torch.float64]["grads"].items()})
    print(f"bf16 vs fp64 gradients: JAX cos {j_cos:.4f} ratio {j_ratio:.4f},"
          f" port cos {p_cos:.4f} ratio {p_ratio:.4f}")
    assert p_cos >= j_cos - 0.05, (p_cos, j_cos)
    assert abs(p_ratio - 1) <= abs(j_ratio - 1) + 0.05, (p_ratio, j_ratio)


def test_build_model_returns_eval_and_trains_on_request():
    model = build_model(_cfg(), device="cpu")
    assert not model.training
    model.train()
    out = model({k: torch.from_numpy(v) for k, v in _batch(4).items()})
    assert out["prediction"].shape == (1, 1, 8, 1, 32)
    assert out["prediction"].requires_grad


@pytest.mark.parametrize("n", [2, 37])
def test_bn_fold_training_matches_jax_bn_fold(n):
    """BNFold in training against the JAX ``_BNFold`` on the same sums:
    biased var to normalise, unbiased var into running_var, momentum 0.1
    (flax 0.9), one count per call."""
    rng = np.random.default_rng(n)
    y = rng.normal(1.0, 2.0, size=(n, 16)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, size=16).astype(np.float32)
    bias = rng.normal(0.0, 0.1, size=16).astype(np.float32)
    mean, var = y.mean(0), (y * y).mean(0) - y.mean(0) ** 2
    jm = jblocks._BNFold(16)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.full(16, 0.3, np.float32),
                                 "var": np.full(16, 1.5, np.float32)}}
    (s_ref, b_ref), upd = jm.apply(variables, jnp.asarray(mean),
                                   jnp.asarray(var), True, n,
                                   mutable=["batch_stats"])
    bn = tblocks.BNFold(16).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(1.5)
    yt = torch.from_numpy(y)
    s, b = bn.folded(torch.float32, yt)
    assert_rel(s.detach().numpy(), s_ref, "s")
    assert_rel(b.detach().numpy(), b_ref, "b")
    assert_rel(bn.running_mean.numpy(), upd["batch_stats"]["mean"], "mean")
    assert_rel(bn.running_var.numpy(), upd["batch_stats"]["var"], "var")
    assert bn.num_batches_tracked.item() == 1


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(9)
    pred = rng.uniform(0.0, 1.0, size=(3, 1, 8, 1, 32)).astype(np.float32)
    pred[0, 0, 0, 0, :4] = [0.0, 1.0, 1e-30, 1.0 - 1e-7]  # the -100 clamp
    mask = (rng.random((3, 1, 8, 1, 32)) > 0.7).astype(np.float32)
    mask[2] = 0.0
    pred[2] = 0.1  # empty prediction and mask: Dice 1
    tb, tp = {"mask": torch.from_numpy(mask)}, {
        "prediction": torch.from_numpy(pred)}
    jb, jp = {"mask": jnp.asarray(mask)}, {"prediction": jnp.asarray(pred)}
    got, parts = _criterion(tlosses)(tb, tp)
    ref, ref_parts = _criterion(jlosses)(jb, jp)
    assert_rel(got.numpy(), ref, "Mix")
    for k in ref_parts:
        assert_rel(parts[k].numpy(), ref_parts[k], k)
    for fn in ("dice_per_sample", "bce_scalar"):
        assert_rel(getattr(tmetrics, fn)(tp["prediction"], tb["mask"]),
                   getattr(jmetrics, fn)(jp["prediction"], jb["mask"]), fn)


def test_sgd_matches_optax_chain():
    """``train.optim.sgd`` (torch.optim.SGD) against the JAX package's optax
    chain over three steps: coupled weight decay, momentum from step 2."""
    w0 = np.random.default_rng(0).normal(size=(7,)).astype(np.float32)
    grads = [np.random.default_rng(i + 1).normal(size=(7,)).astype(
        np.float32) for i in range(3)]
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = sgd([p], LR)
    tx = joptim.sgd(LR)
    params = jnp.asarray(w0)
    state = tx.init(params)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = params + upd
    assert_rel(p.detach().numpy(), params, "params")
