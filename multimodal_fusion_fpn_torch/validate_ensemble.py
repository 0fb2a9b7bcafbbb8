"""Ensemble evaluation entry point of the port: the twin of the JAX
package's ``validate_ensemble.py``, with its CLI and the logic of its
``run`` (``validate_ensemble.py:82-222``).

    python -m multimodal_fusion_fpn_torch.validate_ensemble \\
        --training-dataset hrf_fusion --model FPNHybridFusion \\
        --crop relative_2d_max --fusion-modality slo --version V ...
    python -m multimodal_fusion_fpn_torch.validate_ensemble \\
        --training-dataset vrc --model FPNHybridFusion \\
        --crop relative_2d_max --fusion-modality slo \\
        --mask-variant sq_proj_dil --version V ...

The training parser gains the 10 eval flags, ``--output-features``,
``--eval-shape-bucket`` (default 64) and ``--eval-batch``.  The run seeds
``1234 + repetition``, derives the output path (the cross-dataset
``A-to-B`` and cross-split ``s1-to-s2`` renames included), exits 0 when
the results exist (unless ``--force-repeat``) and after building the model
under ``--exec-test``, loads exactly 5 ``epoch=*.ckpt`` members in sorted
order, runs them as one ensemble (:mod:`.eval.ensemble`) through the
harness and writes the result tree: per image ``test.png``,
``test_soft.png``, ``mask.png`` and ``info.json``; ``test_output.csv``,
``results_dict.json``, ``mean_results.json``, ``global_metrics.json`` (the
test dataset's global pixel metrics: for ``vrc`` AUROC, AUPR, Sens, Spec,
Acc, AP and F1 over every pixel of the run; ``{}`` for the others); and
``all_outputs.npz`` under ``--save-all-outputs``.  The VRC datasets
(``vrc``, ``vrc_crop``, ``vrc_lr2``, ``vrc_lr2_comp_only``) take
``--mask-variant`` / ``--eval-mask-variant`` (``sq_proj_dil``: the
OCT-grid mask, which the nets with a 3D half predict on; otherwise the
SLO-grid ``vs.vmirror``, for the en-face net); ``vrc``'s model path
names the variant (``vrc_<mask variant>``, ``paths.py``).

:func:`run` runs on the card (``device="cuda"``) through the kernels, or
on the CPU when the caller passes ``device="cpu"``; nothing falls back to
the CPU or to the plain versions by itself.  ``kernels=False`` runs the
plain versions on the card (for comparisons).  ``--debug-images`` writes
each image's strip (``viz.debug_batch``) under ``__images``.  The eval
block fusion (``MMF_FUSED_CHAIN`` / ``MMF_FUSED_PAIR`` in the JAX
package) stays off.
"""

import json
import os
import sys
import time
from os.path import join
from pathlib import Path

import numpy as np
import torch

from multimodal_fusion_fpn_torch import paths as path_utils
from multimodal_fusion_fpn_torch.config import (build_parser, derive,
                                                pretty_print)
from multimodal_fusion_fpn_torch.eval.configs import opt_factory
from multimodal_fusion_fpn_torch.eval.ensemble import make_ensemble_eval_step
from multimodal_fusion_fpn_torch.eval.harness import (get_mean_results,
                                                      run_evaluation_instance)
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.train.checkpoints import (
    find_topk_checkpoints, load_checkpoint)
from multimodal_fusion_fpn_torch.train.configs import data_config_factory


def extend_parser(parser):
    parser.add_argument("--noise", type=str, default=None,
                        help="Noise applied to one modality. "
                             "Format: <modality>-<noise_type>")
    parser.add_argument("--noise-level", type=float, default=None)
    parser.add_argument("--debug-images", action="store_true")
    parser.add_argument("--test-dataset", type=str, default=None)
    parser.add_argument("--eval-split", type=str, default=None)
    parser.add_argument("--save-all-outputs", action="store_true")
    parser.add_argument("--force-repeat", action="store_true")
    parser.add_argument("--dont-save", action="store_true")
    parser.add_argument("--eval-mask-variant", type=str, default=None)
    parser.add_argument("--repetition", type=int, default=-1)
    parser.add_argument(
        "--output-features", action="store_true",
        help="Emit pre-fusion branch features from the late-fusion models "
             "(saved as features.png per image).")
    parser.add_argument(
        "--eval-shape-bucket", type=int, default=64,
        help="Pad eval volumes to multiples of this bucket (0 = off).  "
             "Exact: the true extents travel with the batch and the "
             "padded run gives the unpadded prediction on the valid "
             "region.")
    parser.add_argument(
        "--eval-batch", type=int, default=1,
        help="Group images of identical true shape into one ensemble "
             "dispatch (per-image metrics and artifacts unchanged).")
    return parser


def _output_path(args, config, opt, current_model_path, training_split_name,
                 eval_split_name, noise_dir):
    """``__test/[<noise>/][rep_<r>/]<the run path under the training root>``
    with the training dataset renamed ``<train>-to-<test>`` and the
    training split ``<s1>-to-<s2>[--<eval mask variant>]`` when they
    differ (``validate_ensemble.py:145-160``)."""
    test_name = (config.training_dataset
                 if config.training_dataset == args.test_dataset
                 else f"{config.training_dataset}-to-{args.test_dataset}")
    output_path = opt.results_path
    if args.noise is not None:
        output_path = join(output_path, noise_dir)
    if args.repetition >= 0:
        output_path = join(output_path, f"rep_{args.repetition}")
    rel = os.path.relpath(current_model_path, config.models_path)
    output_path = os.path.join(
        output_path, rel.replace(config.training_dataset, test_name))
    if training_split_name != eval_split_name:
        repl = "{}-to-{}".format(training_split_name, eval_split_name)
        if args.eval_mask_variant is not None:
            repl += "--" + args.eval_mask_variant
        output_path = output_path.replace(training_split_name, repl)
    return output_path


def run(argv=None, device="cuda", kernels: bool = True):
    """Evaluate the ensemble that ``argv`` names (see the module note).
    Returns {"output_path", "images", "seconds": the wall time from the
    call to the last artifact, "timing": the harness's split of it
    ("load", "step", "metrics", "artifacts"), "evaluate", the seconds
    of the harness's loop, and "global_metrics", those of the global pixel
    metrics}."""
    t_start = time.perf_counter()
    parser = extend_parser(build_parser())
    args = parser.parse_args(argv)
    config = derive(args)
    print(pretty_print(config))

    if args.test_dataset is None:
        args.test_dataset = args.training_dataset
    opt = opt_factory[args.test_dataset](config)

    if args.noise is not None:
        assert args.noise_level is not None
        args.noise = f"{args.noise}-{args.noise_level}"
    noise_dir = args.noise if args.noise is not None else "no-noise"

    seed = 1234 + args.repetition
    np.random.seed(seed)
    opt.results_path = "./__test/"

    if args.eval_split is None:
        if args.split_name is not None:
            args.eval_split = args.split_name
            eval_split_fn = join(opt.paths["oct"], args.eval_split)
        else:
            args.eval_split = opt.paths["split"]
            eval_split_fn = args.eval_split
    else:
        eval_split_fn = join(opt.paths["oct"], args.eval_split)
    if not eval_split_fn.endswith(".json"):
        eval_split_fn += ".json"
    eval_split_name = Path(eval_split_fn).stem
    print("Using split:", eval_split_fn)
    with open(eval_split_fn, "r") as f:
        eval_split = json.load(f)

    if args.dont_save:
        opt.save_data = False
    if args.eval_mask_variant is not None:
        opt.mask_variant = args.eval_mask_variant
    print(opt)

    all_outputs = {"pred": np.array([]), "gt": np.array([])}
    data_transform_val = opt.get_val_transforms()

    if args.split_name is not None:
        training_split = join(opt.paths["oct"], args.split_name)
    else:
        training_split = data_config_factory[
            config.training_dataset](config).paths["split"]
    current_model_path, training_split_name = path_utils.get_model_path(
        config, training_split, None, True)
    print("Current model path:", current_model_path)
    assert os.path.exists(current_model_path), current_model_path

    output_path = _output_path(args, config, opt, current_model_path,
                               training_split_name, eval_split_name,
                               noise_dir)
    print("\n>>> Output path: {}\n".format(output_path))

    if args.save_all_outputs:
        if os.path.exists(join(output_path, "all_outputs.npz")) \
                and not args.force_repeat:
            print("All outputs file already exists. Skipping.")
            sys.exit(0)
    elif os.path.exists(join(output_path, "mean_results.json")) \
            and not args.force_repeat:
        print("Results file already exists. Skipping.")
        sys.exit(0)

    Path(join(output_path, "__images")).mkdir(parents=True, exist_ok=True)

    model_paths = find_topk_checkpoints(current_model_path)
    print("Model paths ({}): {}".format(len(model_paths), model_paths))
    assert len(model_paths) == 5, model_paths

    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    model = build_model(config, dtype=dtype, device=device)

    if isinstance(eval_split, list):
        val_ids = {"ids": eval_split}
    elif isinstance(eval_split, dict):
        val_ids = eval_split["test"]
    else:
        raise ValueError("Unknown split data type")

    if config.exec_test:
        print("Skipping. exec_test is True.")
        sys.exit(0)

    template = model.state_dict()
    members = []
    for path_weights in model_paths:
        print(f"Loading weights from {path_weights}")
        members.append(load_checkpoint(path_weights, template))
    use_hd_device = any(getattr(m, "device", False)
                        for m in opt.metrics_val.values())
    step = make_ensemble_eval_step(model, members, device=device,
                                   with_hd=use_hd_device)

    results, results_dict, timing = [], {}, {}
    t_eval = time.perf_counter()
    run_evaluation_instance(
        opt, all_outputs, val_ids, data_transform_val, step,
        opt.metrics_val, results, results_dict, output_path,
        noise=args.noise, debug_images=args.debug_images, noise_seed=seed,
        shape_bucket=args.eval_shape_bucket, eval_batch=args.eval_batch,
        kernels=kernels, timing=timing)
    t_eval = time.perf_counter() - t_eval

    tables = {}
    get_mean_results(opt, all_outputs, results, results_dict, output_path,
                     timing=tables)

    if args.save_all_outputs:
        assert all_outputs["pred"].shape == all_outputs["gt"].shape
        np.savez_compressed(join(output_path, "all_outputs.npz"),
                            pred=all_outputs["pred"],
                            gt=all_outputs["gt"])
    return {"output_path": output_path, "images": len(results),
            "seconds": time.perf_counter() - t_start, "evaluate": t_eval,
            "timing": timing, "global_metrics": tables["global_metrics"]}


if __name__ == "__main__":
    run()
