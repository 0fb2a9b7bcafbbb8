"""The port's serving entry point against the JAX package's, on the CPU.

* Configs and paths: ``tests/test_e2e.py``'s argv through both parsers
  (the same derived fields and model path), and the output path of both
  ``validate_ensemble.run`` under ``--exec-test``, with the cross-dataset
  ``A-to-B`` and cross-split ``s1-to-s2`` renames, noise and repetition.
* Checkpoints: a ``.ckpt`` in the original project's Lightning layout
  (``model.`` prefix, the legacy ``resensenet`` root) read by JAX's
  ``import_torch_checkpoint`` and mapped back with the port's
  ``state_dict_from_jax`` gives the tensors the port's ``load_checkpoint``
  reads; late fusion's orphan ``resensnet3d.final1.*`` is dropped, and
  any other stray key or shape is refused.
* Aggregation: the same metric rows, NaN and inf among them, through
  JAX's pandas ``get_mean_results`` and the port's: ``test_output.csv``
  and ``results_dict.json`` byte for byte, ``mean_results.json`` at rtol
  1e-12 (pandas' C float parser may land an ulp off the written value).
* End to end: ``tests/test_e2e.py``'s synthetic HRF data, tiny ini and
  argv, five seeded members (the port's ``init_state_dict``, the final
  bias moved so that the predictions straddle 0.5, mapped into JAX trees
  by ``torch_import.map_state_dict``), each package's checkpoints in its
  own working directory, and both ``validate_ensemble.run`` (fp32, bucket
  64, ``--eval-batch 2``, ``--save-all-outputs``): the same result tree
  within the tolerances of ``test_entry_point_matches_jax``.  This is the
  file's one JAX compile and trace: the ensemble step, at LLVM level 0 as
  the port's other JAX references (``_at_level_0``); the JAX trees'
  templates come from the JAX package's name table (``_jax_template``,
  ``_shape_template``).
"""

import contextlib
import io
import json
import os
import re
import types
from os.path import join

import imageio.v2 as iio
import jax
import numpy as np
import pytest
import torch

import validate_ensemble as jve
from multimodal_fusion_fpn_tpu import paths as jpaths
from multimodal_fusion_fpn_tpu.config import parse_config as jparse
from multimodal_fusion_fpn_tpu.eval import harness as jharness
from multimodal_fusion_fpn_tpu.train.checkpoints import \
    import_torch_checkpoint
from multimodal_fusion_fpn_tpu.train.checkpoints import \
    save_checkpoint as jsave_checkpoint
from multimodal_fusion_fpn_tpu.train.state import TrainState as JState
from multimodal_fusion_fpn_tpu.train.torch_import import map_state_dict

from multimodal_fusion_fpn_torch import paths as tpaths
from multimodal_fusion_fpn_torch import validate_ensemble as tve
from multimodal_fusion_fpn_torch.config import make_config, parse_config
from multimodal_fusion_fpn_torch.data.imageio_utils import imread
from multimodal_fusion_fpn_torch.data.synthetic import make_synthetic_hrf
from multimodal_fusion_fpn_torch.eval import harness as tharness
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.train.checkpoints import (
    find_topk_checkpoints, load_checkpoint, save_checkpoint)
from multimodal_fusion_fpn_torch.weights import (init_state_dict,
                                                 state_dict_from_jax)

from test_torch_model import compile_ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY_INI = """[architecture]
architecture-name=ModifiedUnet3D
is-deconv=false
channels=2,4,8,16,32
dropout=0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0
is-batchnorm=True
"""
MEMBERS = 5
# a thresholded artifact is held exactly only where the JAX prediction
# lies farther than this from 0.5
MARGIN = 1e-4


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """``tests/test_e2e.py``'s synthetic data (written by the port) and
    tiny ini."""
    root = tmp_path_factory.mktemp("entry")
    paths = make_synthetic_hrf(str(root / "data"), n_patients=6, d=16,
                               h=64, w=32, enface_h=80, enface_w=32, seed=3)
    ini = root / "tiny.ini"
    ini.write_text(TINY_INI)
    return {"root": root, "paths": paths, "ini": str(ini)}


def _argv(run_dirs, extra=()):
    return [
        "--training-dataset", "hrf_fusion",
        "--model", "FPNHybridFusion",
        "--crop", "relative_2d_max",
        "--fusion-modality", "slo",
        "--version", "e2e_test",
        "--data-root", run_dirs["paths"]["oct"],
        "--split-name", "split",
        "--arch-config", run_dirs["ini"],
        "--multiplier", "2",
        "--batch-size", "2",
        "--epochs", "5",
        "--threads", "2",
    ] + list(extra)


# --- configs and paths ---------------------------------------------------

def test_config_and_model_path_match_jax(run_dirs):
    for extra in ([], ["--precision", "bf16", "--mesh", "data=1",
                       "--bn-sync", "--learning-rate", "0.01",
                       "--legacy-path", "--suffix", "x",
                       "--model-weights", "../a/last.ckpt"]):
        argv = _argv(run_dirs, extra)
        got, want = parse_config(argv), jparse(argv)
        assert vars(got) == vars(want)
        for split in (run_dirs["paths"]["split"], "other/s2.json"):
            for idx in (None, 3):
                assert tpaths.get_model_path(got, split, idx, True) == \
                    jpaths.get_model_path(want, split, idx, True)
    assert vars(make_config(model="FPN2D", epochs=3)) == vars(
        jparse(["--training-dataset", "hrf", "--model", "FPN2D",
                "--epochs", "3"]))


def _output_path(run, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exc:
        run(argv)
    assert exc.value.code == 0
    return re.search(r">>> Output path: (\S+)", out.getvalue()).group(1)


def test_output_path_matches_jax(run_dirs, monkeypatch):
    """Both entry points under ``--exec-test`` (the JAX one builds its
    model, compiles nothing, and exits) name the same output path."""
    monkeypatch.chdir(run_dirs["root"])
    cfg = parse_config(_argv(run_dirs))
    model_path = tpaths.get_model_path(cfg, run_dirs["paths"]["split"])
    os.makedirs(model_path, exist_ok=True)
    with open(run_dirs["paths"]["split"]) as f:
        split = json.load(f)
    with open(join(run_dirs["paths"]["oct"], "s2.json"), "w") as f:
        json.dump(split["test"], f)
    for i in range(MEMBERS):
        open(join(model_path, f"epoch={i}.ckpt"), "w").close()
    cases = [[], ["--test-dataset", "hrf"],
             ["--eval-split", "s2"],
             ["--eval-split", "s2", "--eval-mask-variant", "oct"],
             ["--noise", "slo-gaussian", "--noise-level", "0.2",
              "--repetition", "2"]]
    seen = set()
    for extra in cases:
        argv = _argv(run_dirs, ["--exec-test"] + extra)
        got = _output_path(lambda a: tve.run(a, device="cpu"), argv)
        assert got == _output_path(jve.run, argv)
        seen.add(got)
    assert len(seen) == len(cases)
    assert any("hrf_fusion-to-hrf" in p for p in seen)
    assert any("split-to-s2--oct" in p for p in seen)
    assert len(find_topk_checkpoints(model_path)) == MEMBERS


def test_debug_images_raise(run_dirs):
    with pytest.raises(NotImplementedError, match="M8"):
        tve.run(_argv(run_dirs, ["--debug-images"]), device="cpu")


# --- checkpoints ---------------------------------------------------------

def _jax_template(sd):
    """The JAX trees' structure and shapes for the port's state dict
    ``sd``, by the JAX package's own name table (``map_state_dict`` with
    nothing to check against), with no JAX trace: that the table gives the
    JAX models' own trees is held for every zoo model by
    ``test_state_dict_round_trips_through_torch_import`` of
    ``tests/test_torch_model.py`` and ``tests/test_torch_zoo.py``, and here
    by the JAX entry point, whose model applies the trees."""
    params, stats = map_state_dict(sd, {}, {}, strict=False)
    shapes = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.float32), t)
    return {"params": shapes(params), "batch_stats": shapes(stats)}


@pytest.mark.parametrize("name", ["FPNHybridFusion", "FPNLateFusion"])
def test_checkpoint_round_trip_matches_jax_import(tmp_path, name):
    cfg = types.SimpleNamespace(model=name, crop="relative_2d_max",
                                fusion_modality="slo", number_of_outputs=1)
    model = build_model(cfg, spec=ArchSpec(channels=(2, 4, 8, 16, 32)),
                        device="cpu")
    sd = init_state_dict(model, 3)
    ref = {"model." + k.replace("resensnet", "resensenet"): v
           for k, v in sd.items()}
    if name == "FPNLateFusion":   # the reference's unused 3D final1
        ref["model.resensenet3d.final1.weight"] = torch.ones(1, 2, 1, 1, 1)
        ref["model.resensenet3d.final1.bias"] = torch.ones(1)
    path = str(tmp_path / "epoch=0.ckpt")
    torch.save({"epoch": 0, "state_dict": ref}, path)

    template = _jax_template(sd)
    params, stats = import_torch_checkpoint(path, template["params"],
                                            template["batch_stats"])
    want = state_dict_from_jax(params, stats)
    got = load_checkpoint(path, model.state_dict())
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
    model.load_state_dict(got, strict=True)

    # the port's own writer: the same layout, read back the same
    save_checkpoint(str(tmp_path / "own.ckpt"), sd)
    own = load_checkpoint(str(tmp_path / "own.ckpt"), sd)
    assert all(torch.equal(own[k], sd[k]) for k in sd)
    # anything but the known orphan is refused
    for bad in ({**ref, "model.resensenet.stray.weight": torch.ones(1)},
                {k: v for k, v in list(ref.items())[1:]},
                {**ref, next(iter(ref)): torch.ones(3)}):
        torch.save({"state_dict": bad}, path)
        with pytest.raises(ValueError):
            load_checkpoint(path, model.state_dict())


# --- aggregation ---------------------------------------------------------

def _rows(n):
    rng = np.random.default_rng(n)
    rows = []
    for i in range(n):
        row = {"VRCPatId": f"P{i:03d}", "FileSetId": f"P{i:03d}V0"}
        for k in ("Dice", "BCE", "Hausdorff", "Hausdorff95", "Area",
                  "Area_manual"):
            row[k] = float(rng.random() * 10.0 ** rng.integers(-6, 4))
        row["Area_diff"] = row["Area"] - row["Area_manual"]
        rows.append(row)
    if n > 1:
        rows[0]["Hausdorff"] = float("nan")
        rows[1]["Hausdorff95"] = float("inf")
        rows[1]["Dice"] = 0.1 + 0.2
        rows[-1]["BCE"] = 1e-300
        del rows[-1]["Area_diff"]
    return rows


def test_image_artifacts_match_jax(tmp_path):
    """``compute_metrics`` of both harnesses on the same numpy outputs
    (with the late-fusion net's ``out_features``) and batches, two images
    into one output directory: the same files, ``info.json`` and
    ``all_outputs`` equal, the PNGs pixel for pixel (``features.png``
    through ``ops/resize.py``), and ``mask.png`` written only once."""
    from multimodal_fusion_fpn_torch.metrics import streaming as TM
    from multimodal_fusion_fpn_tpu import metrics as JM
    rng = np.random.default_rng(11)
    metrics = {m: (getattr(TM, m)("prediction", "mask"),
                   getattr(JM, m)("prediction", "mask"))
               for m in ("Dice", "BCE", "Hausdorff", "Hausdorff95")}
    acc = {t: {"pred": np.array([]), "gt": np.array([])}
           for t in ("jax", "torch")}
    rows = {"jax": ([], {}), "torch": ([], {})}
    for t in ("jax", "torch"):   # an earlier run's mask.png stays
        (tmp_path / t / "V0").mkdir(parents=True)
        (tmp_path / t / "V0" / "mask.png").write_bytes(b"kept")
    for i in range(2):
        y, x = 12 + 4 * i, 20
        pred = rng.random((1, 1, y, 1, x)).astype(np.float32)
        batch = {"mask": (rng.random((1, 1, y, 1, x)) > 0.6).astype(
                     np.float32),
                 "spacing": np.array([[0.12, 0.004, 0.012]]),
                 "FileSetId": [f"V{i}"], "VRCPatId": [f"P{i}"]}
        out = {"prediction": pred,
               "out_features": rng.normal(size=(1, 8, y, 1, x)).astype(
                   np.float32)}
        for t in ("jax", "torch"):
            d = tmp_path / t
            if t == "jax":
                jharness.compute_metrics(
                    acc[t], dict(out), batch,
                    {k: v[1] for k, v in metrics.items()}, *rows[t], str(d))
            else:
                tharness.compute_metrics(
                    dict(out), batch, {k: v[0] for k, v in metrics.items()},
                    *rows[t], acc[t], str(d))
    assert rows["torch"] == rows["jax"]
    for k in ("pred", "gt"):
        np.testing.assert_array_equal(acc["torch"][k], acc["jax"][k])
    tfiles, jfiles = _tree(tmp_path / "torch"), _tree(tmp_path / "jax")
    assert sorted(tfiles) == sorted(jfiles) and len(jfiles) == 10
    for rel, path in jfiles.items():
        if rel == "V0/mask.png":
            assert open(tfiles[rel], "rb").read() == b"kept"
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(imread(tfiles[rel]),
                                          np.asarray(iio.imread(path)))
        else:
            assert json.load(open(tfiles[rel])) == json.load(open(path))


@pytest.mark.parametrize("n", [1, 2, 7])
def test_aggregation_matches_pandas(tmp_path, n):
    opt = types.SimpleNamespace(
        metrics_val={k: None for k in ("Dice", "BCE", "Hausdorff",
                                       "Hausdorff95", "Area")},
        global_metrics={})
    outs = {}
    for tag, harness in (("jax", jharness), ("torch", tharness)):
        d = tmp_path / tag
        d.mkdir()
        rows = _rows(n)
        harness.get_mean_results(
            opt, {"pred": np.zeros(3), "gt": np.zeros(3)}, rows,
            {r["FileSetId"]: r["Dice"] for r in rows}, str(d))
        outs[tag] = d
    for name in ("test_output.csv", "results_dict.json",
                 "global_metrics.json"):
        assert (outs["torch"] / name).read_bytes() == \
            (outs["jax"] / name).read_bytes(), name
    got = json.loads((outs["torch"] / "mean_results.json").read_text())
    want = json.loads((outs["jax"] / "mean_results.json").read_text())
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys()
        np.testing.assert_allclose([got[k][s] for s in want[k]],
                                   [want[k][s] for s in want[k]],
                                   rtol=1e-12, atol=0)


# --- end to end ----------------------------------------------------------

def _members(cfg, run_dirs):
    """Five seeded members for the port, each with its final bias moved
    by minus the median logit of its prediction on the first test image,
    so that the thresholded artifacts are not empty."""
    model = build_model(cfg, device="cpu")
    from multimodal_fusion_fpn_torch.eval.configs import opt_factory
    from multimodal_fusion_fpn_torch.eval.harness import \
        create_val_dataloader
    opt = opt_factory["hrf_fusion"](cfg)
    with open(run_dirs["paths"]["split"]) as f:
        ids = json.load(f)["test"]
    batch = next(iter(create_val_dataloader(opt, ids,
                                            opt.get_val_transforms(), 0)))
    b = {k: torch.from_numpy(batch[k]) for k in ("image", "slo")}
    sds = []
    for seed in range(MEMBERS):
        sd = init_state_dict(model, seed)
        model.load_state_dict(sd)
        with torch.inference_mode():
            p = model(b)["prediction"].double().clamp(1e-12, 1 - 1e-12)
        sd["resensnet.final1.bias"] -= float(torch.logit(p).median())
        sds.append(sd)
    return sds


def _tree(out):
    files = {}
    for d, _, names in os.walk(out):
        for n in names:
            files[os.path.relpath(join(d, n), out)] = join(d, n)
    return files


def _shape_template(template):
    """A stand-in for the JAX entry point's ``create_train_state``, whose
    compiled init run costs more CPU than the rest of this file and gives
    its checkpoint loader only the variables' structure and shapes: it
    gives them from ``template`` (``_jax_template``)."""
    return lambda *a, **k: JState(step=0, params=template["params"],
                                  batch_stats=template["batch_stats"],
                                  opt_state=None)


def _at_level_0(make_step):
    """``make_ensemble_eval_step`` whose jitted step compiles through
    ``compile_ref`` (LLVM optimisation level 0, as every JAX reference of
    the port's tests), once per argument structure and shapes."""
    def make(model, **kw):
        step, compiled = make_step(model, **kw), {}

        def run(*args):
            key = str(jax.tree.map(lambda a: (np.shape(a), str(
                getattr(a, "dtype", type(a)))), args))
            if key not in compiled:
                compiled[key] = compile_ref(step.lower(*args))
            return compiled[key](*args)
        return run
    return make


@pytest.fixture(scope="module")
def both_runs(run_dirs, tmp_path_factory):
    """Both entry points on the same argv, data and members, each in its
    own working directory, then a second run of each, which must skip:
    (the two output paths, the port run's info, the second runs' exit
    codes)."""
    argv = _argv(run_dirs, ["--save-all-outputs", "--eval-batch", "2"])
    cfg = parse_config(argv)
    sds = _members(cfg, run_dirs)
    template = _jax_template(sds[0])
    rel_model = tpaths.get_model_path(cfg, run_dirs["paths"]["split"])
    cwd = {t: tmp_path_factory.mktemp(t) for t in ("jax", "torch")}
    for t in cwd:
        os.makedirs(join(cwd[t], rel_model))
    for i, sd in enumerate(sds):
        name = f"epoch={i}-Dice={0.5 + i / 100:.4f}.ckpt"
        save_checkpoint(join(cwd["torch"], rel_model, name), sd)
        params, stats = map_state_dict(sd, template["params"],
                                       template["batch_stats"])
        jsave_checkpoint(join(cwd["jax"], rel_model, name),
                         {"params": params, "batch_stats": stats})
    prev = os.getcwd()
    try:
        os.chdir(cwd["jax"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jve, "create_train_state", _shape_template(template))
            mp.setattr(jharness, "make_ensemble_eval_step",
                       _at_level_0(jharness.make_ensemble_eval_step))
            jve.run(argv)
        os.chdir(cwd["torch"])
        info = tve.run(argv, device="cpu")
        skipped = []
        for t, run in (("jax", jve.run),
                       ("torch", lambda a: tve.run(a, device="cpu"))):
            os.chdir(cwd[t])
            with pytest.raises(SystemExit) as exc:
                run(argv)
            skipped.append(exc.value.code)
    finally:
        os.chdir(prev)
    return {t: join(cwd[t], info["output_path"]) for t in cwd}, info, skipped


def _close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.nanmax(
        np.abs(np.where(np.isfinite(want), want, 0)), initial=1e-30),
        err_msg=what)


def test_entry_point_matches_jax(both_runs):
    """The same file names; ``all_outputs.npz``'s ``pred`` within
    1e-4 * max|p| and ``gt`` exact; metric rows, ``info.json`` and
    ``mean_results.json`` at 1e-4; ``mask.png`` exact; ``test.png``, Area,
    HD and HD95 exact where the JAX prediction keeps MARGIN from 0.5 (on
    every pixel for ``test.png``, on the whole image for the metrics), and
    at least one image does; ``test_soft.png`` within one grey level;
    ``global_metrics.json`` ``{}`` in both; a second run of each skips."""
    out, info, skipped = both_runs
    assert skipped == [0, 0]
    tfiles, jfiles = _tree(out["torch"]), _tree(out["jax"])
    assert sorted(tfiles) == sorted(jfiles)
    assert info["images"] == 2 and set(info["timing"]) == {
        "load", "step", "metrics", "artifacts"}

    tz, jz = np.load(tfiles["all_outputs.npz"]), np.load(
        jfiles["all_outputs.npz"])
    assert tz["pred"].dtype == jz["pred"].dtype == np.float64
    pred = jz["pred"]
    assert np.abs(tz["pred"] - pred).max() <= 1e-4 * np.abs(pred).max()
    np.testing.assert_array_equal(tz["gt"], jz["gt"])
    assert (pred > 0.5).any() and (pred < 0.5).any()

    for name in ("global_metrics.json",):
        assert json.load(open(tfiles[name])) == json.load(
            open(jfiles[name])) == {}
    with open(tfiles["results_dict.json"]) as f:
        trd = json.load(f)
    with open(jfiles["results_dict.json"]) as f:
        jrd = json.load(f)
    assert list(trd) == list(jrd) and len(jrd) == 2
    _close(list(trd.values()), list(jrd.values()), what="results_dict")

    tm = json.load(open(tfiles["mean_results.json"]))
    jm = json.load(open(jfiles["mean_results.json"]))
    assert tm.keys() == jm.keys()
    for k in jm:
        _close([tm[k][s] for s in jm[k]], [jm[k][s] for s in jm[k]],
               what=f"mean_results {k}")

    # per image
    clear = 0
    offset = 0
    for fsid in jrd:
        jpng = np.asarray(iio.imread(jfiles[f"{fsid}/test_soft.png"]))
        n = jpng.size
        jpred = pred[offset:offset + n].reshape(jpng.shape)
        offset += n
        far = np.abs(jpred - 0.5) > MARGIN
        thard, jhard = imread(tfiles[f"{fsid}/test.png"]), np.asarray(
            iio.imread(jfiles[f"{fsid}/test.png"]))
        np.testing.assert_array_equal(thard[far], jhard[far])
        np.testing.assert_array_equal(
            imread(tfiles[f"{fsid}/mask.png"]),
            np.asarray(iio.imread(jfiles[f"{fsid}/mask.png"])))
        tsoft = imread(tfiles[f"{fsid}/test_soft.png"]).astype(int)
        assert np.abs(tsoft - jpng.astype(int)).max() <= 1
        ti = json.load(open(tfiles[f"{fsid}/info.json"]))
        ji = json.load(open(jfiles[f"{fsid}/info.json"]))
        assert list(ti) == list(ji)
        for k in ji:
            if isinstance(ji[k], str):
                assert ti[k] == ji[k]
            elif far.all() and k in ("Area", "Hausdorff", "Hausdorff95"):
                assert ti[k] == ji[k] or (np.isnan(ti[k])
                                          and np.isnan(ji[k])), k
            else:
                _close(ti[k], ji[k], what=f"{fsid} {k}")
        clear += bool(far.all())
    assert offset == pred.size
    assert clear >= 1

    # the CSV's rows are the info.json rows
    tcsv = open(tfiles["test_output.csv"]).read().splitlines()
    jcsv = open(jfiles["test_output.csv"]).read().splitlines()
    assert tcsv[0] == jcsv[0] and len(tcsv) == len(jcsv) == 3
