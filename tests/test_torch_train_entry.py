"""The port's training entry point and its helpers against the JAX
package's, on the CPU.

* End to end: ``tests/test_e2e.py``'s synthetic HRF data (written by the
  port), tiny ini and argv with FPN2D (the entry points hold the same
  trainer, loaders and files for every model; the hybrid's float64 train
  step is held in ``tests/test_torch_train.py`` and
  ``tests/test_torch_parallel.py``, and FPN2D's JAX step compiles in a
  fraction of the hybrid's time), 2 epochs, ``--multiplier 1``, both entry points
  (``python -m multimodal_fusion_fpn_torch.train``'s ``run`` and
  ``train.py``'s) from the same weights through ``--model-weights``: a port
  ``.ckpt`` of the port's seeded init, and the msgpack that the JAX
  package's ``save_checkpoint`` writes from the trees that
  ``torch_import.map_state_dict`` maps it to.  ``last.ckpt``'s weights
  and BatchNorm stats at rtol = atol = 1e-5, its step, the same
  ``curves.json`` keys and values at 1e-5, the same checkpoint epochs and
  monitor values within 1e-4; a second run of each exits 0;
  ``--exec-test`` builds and returns in both.  Both models compute in
  float64 here (each entry point's ``build_model`` patched; the JAX run
  under x64): in float32 one step of this net already moves single
  BatchNorm biases by a large part of their size between the two
  packages, where in float64 they agree to rounding
  (``tests/test_torch_trainer.py`` explains why).  The port's pools take the first-max backward here, as
  every JAX pool off the TPU.  The JAX steps compile at LLVM level 1; the
  JAX package's init and debug strips are replaced (a template from the
  name table, no strips), which saves two compiles and changes nothing
  compared here.
* ``--resume`` through the port's entry point with dropout in slots 1 and
  6: a run stopped after epoch 0 and resumed ends bit for bit where the
  uninterrupted run ends (weights, BatchNorm stats, optimizer, step).
* ``viz``: ``curves.json`` byte for byte against JAX's ``CurvePlotter``
  (and ``load(upto)``), ``curves.svg`` an SVG with one polyline per
  series; ``debug_batch``'s panels below the 32-row label band within one
  grey level of JAX's, the band's shape and range.
* ``utils``: the three ``device_prefetch`` cases of
  ``tests/test_misc_runtime.py``; ``count_parameters`` and ``count_convs``
  of the hybrid equal to JAX's on the trees of the name table
  (``test_torch_model.jax_template``); ``normalize_data`` and
  ``MonitorLearning``.
* ``profiling``: ``StepTimer`` and ``trace``.
"""

import contextlib
import io
import json
import os
import threading
import time
from os.path import join

import imageio.v2 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jtrain_entry
from multimodal_fusion_fpn_tpu import utils as jutils
from multimodal_fusion_fpn_tpu import viz as jviz
from multimodal_fusion_fpn_tpu.train import trainer as jtrainer
from multimodal_fusion_fpn_tpu.train.checkpoints import \
    load_checkpoint as jload_checkpoint
from multimodal_fusion_fpn_tpu.train.checkpoints import \
    save_checkpoint as jsave_checkpoint
from multimodal_fusion_fpn_tpu.train.state import TrainState as JState
from multimodal_fusion_fpn_tpu.train.torch_import import map_state_dict

from multimodal_fusion_fpn_torch import paths as tpaths
from multimodal_fusion_fpn_torch import profiling, utils, viz
from multimodal_fusion_fpn_torch import train as ttrain
from multimodal_fusion_fpn_torch.config import make_config, parse_config
from multimodal_fusion_fpn_torch.data.imageio_utils import imread
from multimodal_fusion_fpn_torch.data.synthetic import make_synthetic_hrf
from multimodal_fusion_fpn_torch.models import encoder3d as tenc
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.train import __main__ as ttrain_main
from multimodal_fusion_fpn_torch.train import trainer as ttrainer
from multimodal_fusion_fpn_torch.train.checkpoints import (
    load_checkpoint, load_training_state, save_checkpoint)
from multimodal_fusion_fpn_torch.weights import (init_state_dict,
                                                 state_dict_from_jax)

from test_torch_model import jax_template
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

INI = """[architecture]
architecture-name=ModifiedUnet3D
is-deconv=false
channels=2,4,8,16,32
dropout={}
is-batchnorm=True
"""
NO_DROPOUT = "0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0"
DROPOUT = "0.0,0.2,0.0,0.0,0.0,0.0,0.1,0.0,0.0"
LEVEL_1 = {"xla_backend_optimization_level": 1}


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """``tests/test_e2e.py``'s synthetic data and tiny ini (and one with
    dropout)."""
    root = tmp_path_factory.mktemp("train_entry")
    paths = make_synthetic_hrf(str(root / "data"), n_patients=6, d=16, h=64,
                               w=32, enface_h=80, enface_w=32, seed=3)
    for name, drop in (("tiny", NO_DROPOUT), ("dropout", DROPOUT)):
        (root / f"{name}.ini").write_text(INI.format(drop))
    return {"root": root, "paths": paths}


def _argv(run_dirs, ini="tiny", extra=()):
    return [
        "--training-dataset", "hrf_fusion",
        "--model", "FPN2D",
        "--crop", "relative_2d_max",
        "--fusion-modality", "slo",
        "--version", "train_entry",
        "--data-root", run_dirs["paths"]["oct"],
        "--split-name", "split",
        "--arch-config", str(run_dirs["root"] / f"{ini}.ini"),
        "--multiplier", "1",
        "--batch-size", "2",
        "--epochs", "2",
        "--threads", "2",
    ] + list(extra)


def _files(path):
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            out[os.path.relpath(join(d, n), path)] = join(d, n)
    return out


@contextlib.contextmanager
def _cwd(path):
    prev = os.getcwd()
    os.chdir(path)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            yield
    finally:
        os.chdir(prev)


def _compiled_at_level_1(make):
    def made(*a, **k):
        jitted = make(*a, **k)
        compiled = {}

        def run(*args):
            key = str(jax.tree.map(
                lambda x: (np.shape(x), str(getattr(x, "dtype", type(x)))),
                args))
            if key not in compiled:
                compiled[key] = jitted.lower(*args).compile(LEVEL_1)
            return compiled[key](*args)
        return run
    return made


def _template_state(template):
    """A stand-in for the JAX entry point's ``create_train_state``: zeros
    of the name table's trees (``--model-weights`` replaces them) and of
    the optimizer's state, with no compiled init.  The optimizer's zeros
    are float64, the type the float64 run's momentum takes at its first
    step, so that its train step compiles once, not twice."""
    def make(model, tx, rng, example, params=None, batch_stats=None):
        zeros = lambda t, dt=None: jax.tree.map(  # noqa: E731
            lambda s: np.zeros(s.shape, dt or s.dtype), t)
        params = zeros(template["params"])
        return JState(step=np.int32(0), params=params,
                      batch_stats=zeros(template["batch_stats"]),
                      opt_state=zeros(jax.eval_shape(tx.init, params),
                                      np.float64))
    return make


@pytest.fixture(scope="module")
def both_trained(run_dirs, tmp_path_factory):
    """Both entry points on the same argv and weights, each in its own
    working directory: (the two run directories, the port's info, the exit
    codes of a second run of each, the argv, the working directories)."""
    cfg = parse_config(_argv(run_dirs))
    sd = init_state_dict(build_model(cfg, device="cpu"), 7)
    template = jax_template(sd)
    cwd = {t: tmp_path_factory.mktemp(t) for t in ("jax", "torch")}
    for t in cwd:
        os.makedirs(cwd[t] / "init")
    save_checkpoint(str(cwd["torch"] / "init" / "w.ckpt"), sd)
    params, stats = map_state_dict(sd, template["params"],
                                   template["batch_stats"])
    wide = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), t)
    jsave_checkpoint(str(cwd["jax"] / "init" / "w.ckpt"),
                     {"params": wide(params), "batch_stats": wide(stats)})
    argv = {t: _argv(run_dirs, extra=["--model-weights",
                                      str(cwd[t] / "init" / "w.ckpt")])
            for t in cwd}
    pool = tenc.max_pool3d_cl
    jbuild, tbuild = jtrain_entry.build_model, ttrain_main.build_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain_entry, "create_train_state",
                   _template_state(template))
        mp.setattr(jtrain_entry, "build_model",
                   lambda config, dtype=None: jbuild(config,
                                                     dtype=jnp.float64,
                                                     remat=False))
        mp.setattr(ttrain_main, "build_model",
                   lambda config, dtype=None, device="cpu": tbuild(
                       config, dtype=torch.float64, device=device).double())
        for name in ("make_train_step", "make_eval_step"):
            mp.setattr(jtrainer, name,
                       _compiled_at_level_1(getattr(jtrainer, name)))
        mp.setattr(jtrainer.MonitorLearning, "is_save_time",
                   lambda self: False)
        mp.setattr(tenc, "max_pool3d_cl",
                   lambda x, window, first_max=False: pool(x, window, True))
        with _cwd(cwd["jax"]), jax.enable_x64(True):
            jtrain_entry.run(argv["jax"])
        with _cwd(cwd["torch"]):
            info = ttrain.run(argv["torch"], device="cpu")
        codes = []
        for t, run in (("jax", jtrain_entry.run),
                       ("torch", lambda a: ttrain.run(a, device="cpu"))):
            with _cwd(cwd[t]), pytest.raises(SystemExit) as exc:
                run(argv[t])
            codes.append(exc.value.code)
    rel = tpaths.get_model_path(parse_config(argv["torch"]),
                                run_dirs["paths"]["split"])
    assert rel == tpaths.get_model_path(parse_config(argv["jax"]),
                                        run_dirs["paths"]["split"])
    return ({t: join(cwd[t], rel) for t in cwd}, info, codes, argv, cwd)


def _ckpt_values(files):
    return sorted((n.split("-")[0], float(n.split("=")[-1][:-5]))
                  for n in files if n.startswith("epoch="))


def test_entry_point_matches_train_py(both_trained):
    out, info, codes, _, _ = both_trained
    assert codes == [0, 0]
    tfiles, jfiles = _files(out["torch"]), _files(out["jax"])
    for files in (tfiles, jfiles):
        assert {"last.ckpt", "curves.json", "curves.svg"} <= set(files)
        assert "resume.ckpt" not in files
    assert any(f.startswith("images/") for f in tfiles)
    raw = jload_checkpoint(jfiles["last.ckpt"])
    want = state_dict_from_jax(raw["params"], raw["batch_stats"])
    got = load_checkpoint(tfiles["last.ckpt"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert got[k].item() == info["steps"] == 2
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    extra = load_training_state(tfiles["last.ckpt"])
    assert extra["step"] == int(raw["step"]) == 2
    assert len(extra["optimizer"]["state"]) == len(
        jax.tree.leaves(raw["params"]))

    with open(tfiles["curves.json"]) as f:
        tc = json.load(f)
    with open(jfiles["curves.json"]) as f:
        jc = json.load(f)
    assert list(tc) == list(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert len(jc["Dice (val)"]) == 2
    tv, jv = _ckpt_values(tfiles), _ckpt_values(jfiles)
    assert len(tv) == len(jv) == 2
    for (te, t), (je, j) in zip(tv, jv):
        assert te == je and abs(t - j) <= 1e-4
    assert set(info["timing"]) >= {"load", "step", "val", "save"}
    assert info["images"] == 4 and info["eval_forwards"] >= 2
    assert all(np.isfinite(info["losses"])) and len(info["losses"]) == 2


def test_exec_test_builds_and_returns(run_dirs, tmp_path, monkeypatch):
    """``--exec-test`` builds the model and returns in both entry points
    (the JAX init replaced by the name table's template)."""
    model = build_model(parse_config(_argv(run_dirs)), device="cpu")
    monkeypatch.setattr(jtrain_entry, "create_train_state",
                        _template_state(jax_template(model.state_dict())))
    for run in (jtrain_entry.run, lambda a: ttrain.run(a, device="cpu")):
        with _cwd(tmp_path):
            assert run(_argv(run_dirs, extra=["--exec-test"])) is None
    assert not [f for f in _files(tmp_path) if f.endswith(".ckpt")]


def test_mesh_is_refused(run_dirs, tmp_path):
    """A mesh of two ranks in a run of one process is refused before a
    process group is made (both axes run over several processes:
    ``tests/test_torch_parallel.py``), and nothing is written."""
    with _cwd(tmp_path), pytest.raises(ValueError,
                                       match="needs 2 devices, have 1"):
        ttrain.run(_argv(run_dirs, extra=["--mesh", "data=1,space=2"]),
                   device="cpu")
    assert not _files(tmp_path)
    assert not torch.distributed.is_initialized()


def test_resume_through_the_entry_point_with_dropout(run_dirs, tmp_path):
    """Dropout in slots 1 and 6: stopped after epoch 0 (a KeyboardInterrupt
    once ``resume.ckpt`` is written), then ``--resume``: the same
    ``last.ckpt`` bit for bit as the uninterrupted run, and the curves."""
    argv = _argv(run_dirs, "dropout")
    for d in "abc":
        (tmp_path / d).mkdir()
    with _cwd(tmp_path / "a"):
        full = ttrain.run(argv, device="cpu")
    save = ttrainer.Trainer._save_resume

    def stop_after_first(self, state, epoch, best, patience_left):
        save(self, state, epoch, best, patience_left)
        raise KeyboardInterrupt

    with pytest.MonkeyPatch.context() as mp, _cwd(tmp_path / "b"):
        mp.setattr(ttrainer.Trainer, "_save_resume", stop_after_first)
        first = ttrain.run(argv, device="cpu")
    assert first["interrupted"]
    with _cwd(tmp_path / "b"):
        resumed = ttrain.run(argv + ["--resume"], device="cpu")
    assert not resumed["interrupted"]
    a = _files(tmp_path / "a" / full["model_path"])
    b = _files(tmp_path / "b" / resumed["model_path"])
    assert "resume.ckpt" not in b
    assert sorted(k for k in a if not k.startswith("images/")) == sorted(
        k for k in b if not k.startswith("images/"))
    sa, sb = load_checkpoint(a["last.ckpt"]), load_checkpoint(b["last.ckpt"])
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ea, eb = load_training_state(a["last.ckpt"]), load_training_state(
        b["last.ckpt"])
    assert ea["step"] == eb["step"] == 2
    ma, mb = ea["optimizer"]["state"], eb["optimizer"]["state"]
    assert sorted(ma) == sorted(mb) and all(
        torch.equal(ma[i]["momentum_buffer"], mb[i]["momentum_buffer"])
        for i in ma)
    assert open(a["curves.json"]).read() == open(b["curves.json"]).read()
    # the dropout took part: another seed gives other weights
    with _cwd(tmp_path / "c"):
        other = ttrain.run(argv + ["--seed", "99"], device="cpu")
    sc = load_checkpoint(_files(tmp_path / "c" / other["model_path"])[
        "last.ckpt"])
    assert any(not torch.equal(sa[k], sc[k]) for k in sa)


# --- viz ----------------------------------------------------------------

def _plotters(tmp_path):
    out = {}
    for tag, mod in (("jax", jviz), ("torch", viz)):
        d = tmp_path / tag
        d.mkdir(parents=True)
        out[tag] = mod.CurvePlotter(str(d), ["Dice", "BCE"],
                                    ["Dice", "BCE", "Hausdorff"])
    return out


def test_curves_match_jax(tmp_path):
    plots = _plotters(tmp_path)
    rng = np.random.default_rng(0)
    for epoch in range(3):
        vals = {k: float(v) for k, v in zip(
            ["Dice (train)", "BCE (train)", "Dice (val)", "BCE (val)",
             "Hausdorff (val)"], rng.random(5))}
        vals["Hausdorff (val)"] = float("nan") if epoch == 1 else 3.25
        for p in plots.values():
            for k, v in vals.items():
                p.append(k, v)
            p.save()
    files = {t: p.model_path for t, p in plots.items()}
    assert (open(join(files["torch"], "curves.json"), "rb").read()
            == open(join(files["jax"], "curves.json"), "rb").read())
    import xml.etree.ElementTree as ET
    root = ET.parse(join(files["torch"], "curves.svg")).getroot()
    lines = root.findall("{http://www.w3.org/2000/svg}polyline")
    assert len(lines) == 5
    titles = [t.text for t in root.iter("{http://www.w3.org/2000/svg}text")]
    assert {"Dice", "BCE", "Hausdorff"} <= set(titles)
    dashed = [ln for ln in lines if ln.get("stroke-dasharray")]
    assert len(dashed) == 3
    assert {ln.get("stroke") for ln in lines} == {"#1f77b4", "#ff7f0e",
                                                  "#2ca02c"}
    # load(upto) restores the same series in both
    for upto in (None, 2):
        again = _plotters(tmp_path / f"load{upto}")
        for t, p in again.items():
            p.model_path = files[t]
            p.load(upto=upto)
        assert again["torch"].curves.keys() == again["jax"].curves.keys()
        for k, v in again["jax"].curves.items():
            np.testing.assert_array_equal(again["torch"].curves[k], v)


def test_debug_batch_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    b = 2
    mask = np.zeros((b, 1, 12, 1, 20), np.float32)
    mask[:, :, 3:9, :, 5:15] = 1
    batch = {"image": rng.normal(size=(b, 1, 12, 30, 20)).astype(np.float32),
             "slo": rng.random((b, 1, 40, 1, 20)).astype(np.float32),
             "mask": mask,
             "prediction": rng.random((b, 1, 12, 1, 20)).astype(np.float32),
             "FileSetId": ["P000V0", "P001V0"]}
    paths = {}
    for tag, mod in (("jax", jviz), ("torch", viz)):
        d = tmp_path / tag
        d.mkdir()
        paths[tag] = mod.debug_batch(dict(batch), str(d), name_hint="x")
    assert [os.path.basename(p) for p in paths.values()] == [
        "x.P000V0_P001V0.png"] * 2
    t, j = imread(paths["torch"]), np.asarray(iio.imread(paths["jax"]))
    assert t.shape == j.shape == (32 + 2 * 256, 4 * 256)
    assert np.abs(t[32:].astype(int) - j[32:].astype(int)).max() <= 1
    band = t[:32]
    assert band.min() == 0 and band.max() == 255
    for i in range(4):   # one label per panel, each non-empty
        assert band[:, 256 * i:256 * (i + 1)].any()


# --- utils ------------------------------------------------------------------

def test_device_prefetch_order_and_types():
    batches = [{"x": np.full((4, 4), i, np.float32), "id": f"b{i}"}
               for i in range(7)]
    out = list(utils.device_prefetch(iter(batches), depth=2, device="cpu"))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"][0, 0] == i
        assert b["id"] == f"b{i}"


def test_device_prefetch_propagates_errors():
    def gen():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("loader exploded")

    it = utils.device_prefetch(gen(), depth=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="loader exploded"):
        list(it)


def test_device_prefetch_worker_exits_on_abandon():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield {"x": np.full(2, i, np.float32)}

    before = threading.active_count()
    it = utils.device_prefetch(gen(), depth=1, device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 100


def test_counts_match_jax():
    cfg = make_config(model="FPNHybridFusion", crop="relative_2d_max",
                      fusion_modality="slo")
    model = build_model(cfg, device="cpu")
    params = jax_template(model.state_dict())["params"]
    assert utils.count_parameters(model) == jutils.count_parameters(params)
    assert utils.count_convs(model) == jutils.count_convs(params) > 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        utils.print_net_info(model)
    assert f"Layers: {jutils.count_convs(params)}" in out.getvalue()


def test_normalize_and_monitor_match_jax():
    x = np.random.default_rng(1).normal(size=(5, 7))
    x[0, 0] = np.nan
    np.testing.assert_array_equal(utils.normalize_data(x),
                                  jutils.normalize_data(x))
    m = utils.MonitorLearning()
    assert m.is_save_time() and not m.is_save_time()


# --- profiling --------------------------------------------------------------

def test_step_timer_and_trace(tmp_path):
    fetched = []

    class Sync:
        def __float__(self):
            fetched.append(1)
            return 0.0

    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop(Sync())
    assert len(fetched) == 3 and len(timer.times) == 2
    summary = timer.summary()
    assert summary["steps"] == 2 and set(summary) == {
        "steps", "mean_ms", "p50_ms", "p95_ms", "min_ms"}
    assert profiling.StepTimer().summary() == {"steps": 0}
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None and any(
        "mm" in e.key for e in prof.key_averages())
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
