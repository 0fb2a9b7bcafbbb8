"""The port's process mesh against the JAX package's mesh steps, on the
CPU: two processes over gloo (``torch_dp_launch.spawn``, the ranks' side in
``tests/torch_dp_worker.py``), ``tiny_spec``, a global batch of B=2.

* (a) ``parse_mesh_spec``: the JAX package's dicts and errors; what is
  still refused before any process group is made: a mesh the processes
  cannot fill, widths that do not split over ``space`` at every level,
  and the bucketing extents or ``block_fusion`` under the space axis.
* (b) Per-replica mode (``bn_sync=False``) against the JAX
  ``make_dp_train_step(bn_sync=False)`` on ``make_mesh("data=2,space=2")``
  of four CPU devices with the mesh declared (``set_space_sharding``; the
  ``shard_map`` splits the batch over ``data`` only, so this is the
  ``data=2`` step): one step of FPN2D from the same numpy weights (running stats
  far from the identity) through ``weights.state_dict_from_jax``; the
  parameters, the running stats, the loss, its parts, the two Dice values
  and the BCE, each tensor to max-abs-err <= 1e-4 * max|ref|.  Both sides
  in float64 (the JAX blocks in fused mode "off", every op in float64):
  in float32 a ReLU input within rounding of 0 flips at other places in
  the two packages and moves single gradient tensors by more
  (``tests/test_torch_train.py``).
* (c) Synced mode (``bn_sync=True``) against the JAX ``make_train_step``
  on the global batch, which is what the JAX ``bn_sync=True`` returns, run
  on ``make_mesh("space=2")`` with the batch's width sharded and the mesh
  declared (the JAX space mesh step), at the same tolerance; the hybrid's
  synced step against the port's
  single-process step on the global batch (the kernel routes' stats
  epilogue, K10's entry and the cuDNN stages), and with dropout in every
  slot the synced step against the single-process step from the same
  generator, the per-replica one against the mean of each shard's
  single-process gradients.  The two JAX references compile apart, in
  threads, each while the next is traced: traced into one function they
  took 30 s against 20.
* (d) Per-replica with ``accum_steps=2``: at data=1 bit-equal to the
  port's single-process accumulation step; at data=2 its Dice has 2·B
  values.  No JAX compile.
* (e) After each step the parameters and the running stats are bit-identical
  on the two ranks.
* (f) ``train.run(..., device="cpu")`` with ``--mesh data=2`` in the two
  processes, 1 epoch of 2 steps: rank 0 writes the run's tree, rank 1 (in
  an empty working directory) writes no file and prints nothing; the same
  at ``--mesh data=1,space=2``.
* (g) The space axis, ``data=1,space=2`` in the same two processes: FPN2D
  synced and per replica against (c)'s JAX space mesh step (per replica
  at ``data=1`` each data shard is the whole batch, which is what the JAX
  per-replica step computes on a declared space mesh, (b)); the hybrid's
  synced step, FPN2D with dropout in every slot and per-replica
  accumulation against (c)'s and (d)'s single-process steps on the global
  batch, at the same tolerance.
* (h) ``comm.halo_x`` and ``comm.across_cols`` over three processes and
  over two of them (``torch_dp_worker.halo_ranks``), forward and
  backward, against the whole tensor padded (resized) and sliced: the
  halos at the true edges zero, each halo's cotangent back on its owner.

The ranks run in two spawns (two processes, three for (h)) while the JAX
references are traced and compiled in this process.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_fpn_tpu import losses as jlosses
from multimodal_fusion_fpn_tpu.config import make_config as jmake_config
from multimodal_fusion_fpn_tpu.models import blocks as jblocks
from multimodal_fusion_fpn_tpu.models.zoo import build_model as jbuild
from multimodal_fusion_fpn_tpu.ops.pallas import fused_conv as jfc
from multimodal_fusion_fpn_tpu.parallel import mesh as jmesh
from multimodal_fusion_fpn_tpu.parallel.step import \
    make_dp_train_step as jdp_step
from multimodal_fusion_fpn_tpu.train import optim as joptim
from multimodal_fusion_fpn_tpu.train.state import TrainState as JState
from multimodal_fusion_fpn_tpu.train.step import make_train_step as jstep

from multimodal_fusion_fpn_torch.data.synthetic import make_synthetic_hrf
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.parallel import comm
from multimodal_fusion_fpn_torch.parallel import mesh as tmesh
from multimodal_fusion_fpn_torch.weights import state_dict_from_jax

import torch_dp_worker as worker
from torch_dp_launch import spawn, wait
from test_torch_model import jax_template, random_trees
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LEVEL_1 = {"xla_backend_optimization_level": 1}
INI = """[architecture]
architecture-name=ModifiedUnet3D
is-deconv=false
channels=2,4,8,16,32
dropout=0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0
is-batchnorm=True
"""


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(b, 1, 8, 64, 32)),
            "slo": rng.normal(size=(b, 1, 80, 1, 32)),
            "mask": (rng.random((b, 1, 8, 1, 32)) > 0.7).astype(np.float64)}


def _trees(name, spec, seed):
    sd = build_model(worker.cfg(name), spec=spec, device="cpu").state_dict()
    params, stats = random_trees(jax_template(sd), seed)
    return params, stats, state_dict_from_jax(params, stats)


def _argv(paths, ini):
    return ["--training-dataset", "hrf_fusion", "--model", "FPNHybridFusion",
            "--crop", "relative_2d_max", "--fusion-modality", "slo",
            "--version", "dp", "--data-root", paths["oct"],
            "--split-name", "split", "--arch-config", ini,
            "--multiplier", "1", "--batch-size", "2", "--epochs", "1",
            "--threads", "1"]


def _jax_refs(tiny_spec, params, stats, batch, pool):
    """The JAX per-replica mesh step on ``data=2,space=2`` and the global
    step on the ``space=2`` mesh, each with its mesh declared (futures of
    their numpy (state, aux)), traced here and compiled in ``pool``."""
    wide = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    params, stats = wide(params), wide(stats)
    key = jax.random.PRNGKey(1)
    meshes = {"per_replica": jmesh.make_mesh("data=2,space=2",
                                             jax.devices()[:4]),
              "synced": jmesh.make_mesh("space=2", jax.devices()[:2])}
    prev = jblocks._FUSED_MODE
    jblocks.set_fused_stage_mode("off")
    out = {}
    try:
        with jax.enable_x64(True):
            tx = joptim.sgd(0.1)
            opt0 = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                jax.eval_shape(tx.init, params))
            state = JState(step=jnp.asarray(0), params=params,
                           batch_stats=stats, opt_state=opt0)
            model = jbuild(worker.cfg("FPN2D"), spec=tiny_spec, remat=False,
                           dtype=jnp.float64)
            crit = jlosses.Mix({"Dice Loss": jlosses.dice_loss_joint(),
                                "BCE loss": jlosses.bce_loss()})
            steps = {"per_replica": jdp_step(model, tx, crit,
                                             meshes["per_replica"],
                                             bn_sync=False),
                     "synced": jstep(model, tx, crit, donate=False)}
            for name, step in steps.items():
                mesh = meshes[name]
                args = ((state, batch, key) if name == "per_replica" else
                        (jmesh.shard_state(state, mesh),
                         jmesh.shard_batch(batch, mesh), key))
                jfc.set_space_sharding(mesh)
                try:
                    lowered = step.lower(*args)
                finally:
                    jfc.set_space_sharding(None)
                out[name] = pool.submit(_run, lowered, *args)
    finally:
        jblocks.set_fused_stage_mode(prev)
    return out


def _run(lowered, *args):
    with jax.enable_x64(True):
        state, aux = lowered.compile(LEVEL_1)(*args)
        return (jax.tree.map(np.asarray, (state.params, state.batch_stats)),
                jax.tree.map(np.asarray, aux))


@pytest.fixture(scope="module")
def runs(tiny_spec, tmp_path_factory):
    """The two ranks' results (``torch_dp_worker``), the JAX references
    (futures; under "halo" the three ranks' results of (h)) and the run
    directories of (f)."""
    out = tmp_path_factory.mktemp("dp")
    spec = ArchSpec(tiny_spec.channels)
    params, stats, sd = _trees("FPN2D", spec, 11)
    batch = _batch(0)
    paths = make_synthetic_hrf(str(out / "data"), n_patients=8, d=16, h=64,
                               w=32, enface_h=80, enface_w=32, seed=3)
    (out / "tiny.ini").write_text(INI)
    cwds = {name: [out / name / "rank0", out / name / "rank1"]
            for name in ("entry", "entry_space")}
    for d in cwds["entry"] + cwds["entry_space"]:
        d.mkdir(parents=True)
    torch.save({"channels": tuple(tiny_spec.channels), "sd": sd,
                "batch": batch, "batch2": _batch(1),
                "hybrid_sd": _trees("FPNHybridFusion", spec, 12)[2],
                "hybrid_batch": _batch(2),
                "argv": _argv(paths, str(out / "tiny.ini")),
                "run_cwd": {k: [str(d) for d in v] for k, v in cwds.items()}},
               out / "inputs.pt")
    ctx = spawn(worker.ranks, 2, str(out / "store"), args=(str(out),),
                threads=1, join=False)
    halo_ctx = spawn(worker.halo_ranks, 3, str(out / "halo_store"),
                     args=(str(out),), threads=1, join=False)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        refs = _jax_refs(tiny_spec, params, stats, batch, pool)
        wait(halo_ctx, timeout=300)
        wait(ctx, timeout=300)
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        refs["halo"] = [torch.load(out / f"halo{r}.pt", weights_only=False)
                        for r in range(3)]
        yield ranks, refs, cwds


def _close(got, ref, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, peak = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 1e-4 * peak, (what, err, peak)


def _against_jax(port, ref):
    (params, stats), aux = ref.result()
    want = state_dict_from_jax(params, stats)
    assert set(want) == set(port["sd"])
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            _close(port["sd"][k], v.numpy(), k)
    got = port["aux"]
    _close(got["loss"], aux["loss"], "loss")
    assert set(got["parts"]) == set(aux["parts"])
    for k, v in got["parts"].items():
        _close(v, aux["parts"][k], k)
    assert got["metrics"]["Dice"].shape == (2,)
    _close(got["metrics"]["Dice"], aux["metrics"]["Dice"], "Dice")
    _close(got["metrics"]["BCE"], aux["metrics"]["BCE"], "BCE")


def _all_close(got, ref):
    for k, v in ref.items():
        if v.is_floating_point():
            _close(got[k], v.numpy(), k)
        else:
            assert torch.equal(got[k], v), k


# --- (a) -------------------------------------------------------------------

@pytest.mark.parametrize("spec,n", [(None, 4), ("data=4", 4),
                                    ("data=2,space=2", 4),
                                    (" data = 8 ", 8), ("data=2", 4),
                                    ("data=x", 2), ("data=2;space=1", 2)])
def test_parse_mesh_spec_matches_jax(spec, n):
    try:
        want = jmesh.parse_mesh_spec(spec, n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_spec(spec, n)
        assert str(got.value) == str(exc)
    else:
        assert tmesh.parse_mesh_spec(spec, n) == want


def _lone_mesh(space):
    """A mesh of ``space`` ranks seen from rank 0, with no process group
    behind it: enough for what is refused before any collective."""
    one = comm.Group(pg=None, rank=0, size=1, backend="gloo", ranks=(0,))
    group = comm.Group(pg=None, rank=0, size=space, backend="gloo",
                       ranks=tuple(range(space)))
    return tmesh.Mesh(axes={"data": 1, "space": space}, world=group,
                      data=one, space=group, device=torch.device("cpu"))


@pytest.mark.parametrize("case", ["processes", "widths", "extents",
                                  "block_fusion"])
def test_space_axis_is_refused_before_a_group_is_made(case):
    assert not torch.distributed.is_initialized()
    if case == "processes":
        # a mesh of two ranks in a run of one process
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            tmesh.init_mesh("data=1,space=2", device="cpu")
    elif case == "widths":
        # X = 48 at space=2: level 4 is 6 wide, not a multiple of 2 x 2
        # (the JAX package pads it through GSPMD, tests/test_parallel.py)
        b = {**_batch(0), "image": np.zeros((2, 1, 8, 64, 48))}
        with pytest.raises(ValueError, match="level 4 is 6 wide"):
            tmesh.check_widths(tmesh.shard_batch(b, _lone_mesh(2)),
                               _lone_mesh(2), (2, 2, 2, 2),
                               ("image", "slo"))
    else:
        model = build_model(worker.cfg("FPNHybridFusion"),
                            spec=ArchSpec((2, 4, 8, 16, 32)), device="cpu")
        b = {k: torch.as_tensor(v[..., :16], dtype=torch.float32)
             for k, v in _batch(0).items()}
        kw = {}
        if case == "extents":
            b["__valid_image__"] = torch.tensor([8, 64, 16])
        else:
            kw["block_fusion"] = "pair"
        space = _lone_mesh(2).space
        with comm.sharded(comm.Shards(cols=space, total=space)), \
                pytest.raises(ValueError, match=case.replace("_", ".")):
            model(b, **kw)
    assert not torch.distributed.is_initialized()


# --- (b), (c) -------------------------------------------------------------

def test_per_replica_step_matches_the_jax_mesh_step(runs):
    ranks, refs, _ = runs
    for r in ranks:
        _against_jax(r["per_replica"], refs["per_replica"])


def test_synced_step_matches_the_jax_global_step(runs):
    ranks, refs, _ = runs
    for r in ranks:
        _against_jax(r["synced"], refs["synced"])


def test_synced_hybrid_is_the_global_batch_step(runs):
    ranks, _, _ = runs
    single = ranks[0]["hybrid"]["single"]
    for r in ranks:
        dp = r["hybrid"]["dp"]
        _all_close(dp["sd"], single["sd"])
        _close(dp["aux"]["loss"], single["aux"]["loss"].numpy(), "loss")
        for k in ("Dice", "BCE"):
            _close(dp["aux"]["metrics"][k],
                   single["aux"]["metrics"][k].numpy(), k)


def test_dropout_follows_each_mode(runs):
    ranks, _, _ = runs
    ref = ranks[0]["dropout"]
    for r in ranks:
        _all_close(r["dropout"]["synced"]["sd"], ref["single"]["sd"])
        _all_close(r["dropout"]["synced"]["grads"], ref["single"]["grads"])
        _all_close(r["dropout"]["per_replica"]["grads"], ref["shard_grads"])
    # the masks were drawn: with dropout the synced step lands elsewhere
    assert any(not torch.equal(v, ranks[0]["synced"]["sd"][k])
               for k, v in ref["synced"]["sd"].items()
               if v.is_floating_point())


# --- (d) ------------------------------------------------------------------

def test_accumulation_at_data_1_is_the_single_process_step(runs):
    ranks, _, _ = runs
    single, dp = ranks[0]["accum"]["single"], ranks[0]["accum"]["data1"]
    for k, v in single["sd"].items():
        assert torch.equal(dp["sd"][k], v), k
    assert torch.equal(dp["aux"]["loss"], single["aux"]["loss"])
    for k, v in single["aux"]["metrics"].items():
        assert torch.equal(dp["aux"]["metrics"][k], v), k


def test_accumulation_at_data_2_gathers_every_sample(runs):
    ranks, _, _ = runs
    for r in ranks:
        aux = r["accum"]["data2"]["aux"]
        assert aux["metrics"]["Dice"].shape == (4,)
        assert np.isfinite(aux["loss"].item())
    assert torch.equal(ranks[0]["accum"]["data2"]["aux"]["metrics"]["Dice"],
                       ranks[1]["accum"]["data2"]["aux"]["metrics"]["Dice"])


# --- (e) ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["per_replica", "synced", "hybrid",
                                  "dropout", "accum", "space"])
def test_ranks_hold_bit_identical_state(runs, case):
    ranks, _, _ = runs
    pick = {"hybrid": ("dp",), "dropout": ("synced", "per_replica"),
            "accum": ("data2",),
            "space": ("synced", "per_replica", "hybrid", "dropout",
                      "accum")}.get(case)
    outs = [[r[case]] if pick is None else [r[case][p] for p in pick]
            for r in ranks]
    for a, b in zip(*outs):
        assert set(a["sd"]) == set(b["sd"])
        for k, v in a["sd"].items():
            assert torch.equal(v, b["sd"][k]), k
        assert torch.equal(a["aux"]["loss"], b["aux"]["loss"])


# --- (f) ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["entry", "entry_space"])
def test_entry_point_writes_on_rank_0_only(runs, name):
    """(f) at ``--mesh data=2``, and at ``data=1,space=2``: the entry point
    trains with each rank on its half of the width."""
    ranks, _, run_cwds = runs
    cwds = run_cwds[name]
    infos = [r[name]["info"] for r in ranks]
    for info in infos:
        assert info["steps"] == 2 and info["step"] == 2
        assert info["images"] == 4
        assert all(np.isfinite(v) for v in info["losses"])
    assert infos[0]["losses"] == infos[1]["losses"]
    written = sorted(os.path.relpath(os.path.join(d, n), cwds[0])
                     for d, _, names in os.walk(cwds[0]) for n in names)
    run_dir = os.path.relpath(infos[0]["model_path"], cwds[0])
    names = {os.path.relpath(w, run_dir) for w in written}
    assert {"last.ckpt", "curves.json", "curves.svg"} <= names
    assert any(n.startswith("epoch=0-") and n.endswith(".ckpt")
               for n in names)
    assert "resume.ckpt" not in names
    assert not [n for d, _, ns in os.walk(cwds[1]) for n in ns]
    assert not os.listdir(cwds[1])
    assert ranks[1][name]["stdout"] == ""
    assert "Process mesh" in ranks[0][name]["stdout"]


# --- (g) ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["synced", "per_replica"])
def test_space_step_matches_the_jax_space_mesh_step(runs, mode):
    ranks, refs, _ = runs
    for r in ranks:
        _against_jax(r["space"][mode], refs["synced"])


@pytest.mark.parametrize("case", ["hybrid", "dropout", "accum"])
def test_space_step_is_the_global_batch_step(runs, case):
    ranks, _, _ = runs
    single = ranks[0][case]["single"]
    for r in ranks:
        got = r["space"][case]
        _all_close(got["sd"], single["sd"])
        _all_close(got["grads"], single["grads"])
        _close(got["aux"]["loss"], single["aux"]["loss"].numpy(), "loss")
        for k, v in single["aux"]["metrics"].items():
            assert got["aux"]["metrics"][k].shape == v.shape, k
            _close(got["aux"]["metrics"][k], v.numpy(), k)


# --- (h) ------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_halo_x_is_the_padded_whole_sliced(runs, n):
    _, refs, _ = runs
    cases = [(k, v) for res in refs["halo"] for k, v in res.items()
             if k[1] == n]
    assert len(cases) == n * 5
    for key, (fwd, bwd) in cases:
        assert fwd <= 1e-12 and bwd <= 1e-12, (key, fwd, bwd)
