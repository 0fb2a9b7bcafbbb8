"""CLI flag surface and global configuration: the port's copy of
``multimodal_fusion_fpn_tpu/config.py``, with the same flags and defaults.

API-compatible with the original project's argparse surface
(its ``config.py:20-126``) so that the canonical ``run.sh``
recipes work unchanged, while avoiding the reference's parse-at-import
side effect: here, parsing happens through :func:`parse_config`, and
modules receive the config object explicitly instead of importing a
global singleton.

Crop types (same semantics as the reference, ``config.py:5-17``):
  * ``oct``            – complementary modality resized to OCT en-face size
                         at the *input* level.
  * ``relative_2d``    – complementary features resized to OCT feature size
                         with trilinear interpolation, at the feature level.
  * ``relative_2d_max``– same, but with adaptive max pooling.
  * ``none``           – images used as they are.

Extensions of the JAX package (new flags; all default to
parity-preserving values): ``--precision``, ``--mesh``, ``--bn-sync``.
The port accepts ``--mesh`` and ``--bn-sync`` and does not use them yet
(one card, ROADMAP M10).
"""

import argparse
import socket
from types import SimpleNamespace
from typing import List, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    # --- reference-compatible surface (config.py:20-76) -------------------
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--training-dataset", type=str, required=True)
    parser.add_argument("--version", type=str, default=None)
    parser.add_argument("--data-ratio", type=float, default=1.0)
    parser.add_argument("--early-stopping", type=int, default=None)
    parser.add_argument("--exec-test", action="store_true",
                        help="execution test: build the model graph and exit")
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--val-batch-size", type=int, default=1)
    parser.add_argument("--virtual-batch-size", type=int, default=1)
    parser.add_argument("--compression", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=1e-1)
    parser.add_argument("--fusion-modality", type=str, default=None)
    parser.add_argument("--crop", type=str, default="oct")
    parser.add_argument("--model", type=str, default=None, required=True)
    parser.add_argument("--model-weights", type=str, default=None)
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--force-mem-cache-release", default="ReleaseMemCache")
    parser.add_argument("--number-of-outputs", type=int, default=1)
    parser.add_argument("--filly-annotations", type=str, default=None)
    parser.add_argument("--gpus", type=int, nargs="+", default=1)
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--split-indices", nargs="+", type=int,
                        default=[0, 1, 2, 3, 4])
    parser.add_argument("--legacy-path", action="store_true")
    parser.add_argument("--use-complementary", action="store_true",
                        help="Force use of complementary data")
    parser.add_argument("--split-name", type=str, default=None)
    parser.add_argument("--base-channels", type=int, default=64)
    parser.add_argument("--mask-variant", type=str, default="faf",
                        choices=["vs_proj", "sq_proj_dil", "oct", "faf"],
                        help="mask variant, only for VRC vessel segmentation")
    parser.add_argument("--multiplier", type=int, default=20,
                        help="Multiplier for the training dataset size.")
    parser.add_argument("--rotation-augmentation", action="store_true",
                        help="Use rotation augmentation.")
    parser.add_argument("--local-server-name", type=str, default="server",
                        choices=["server", "msc_server"])
    # --- extensions of the JAX package ----------------------------------
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=["fp32", "bf16"],
                        help="Compute dtype for the model. Parameters and "
                             "batch-norm statistics are always fp32.")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Device mesh spec 'data=N' or 'data=N,space=M'. "
                             "Default: all local devices on the data axis.")
    parser.add_argument("--bn-sync", action="store_true",
                        help="Synchronize batch-norm statistics across data "
                             "shards (reference parity is per-replica: off).")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--arch-config", type=str, default=None,
                        help="Path to an architecture ini file overriding "
                             "the packaged default (channels/dropout/BN).")
    parser.add_argument("--data-root", type=str, default=None,
                        help="Override the dataset root directory used by "
                             "the dataset configs.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume an interrupted run from the last "
                             "epoch-boundary resume.ckpt in the run dir "
                             "(exact: params, BN stats, optimizer state, "
                             "early-stopping state; extension over the "
                             "reference's restart-from-scratch).")
    return parser


def derive(config) -> SimpleNamespace:
    """Apply the reference's derived-config rules (config.py:78-118)."""
    config.DEBUG = config.debug
    config.models_path = f"./__server_train/{config.version}/"
    config.use_complementary = (
        "fusion" in config.model.lower()
        or "2d" in config.model.lower()
        or config.use_complementary
    )
    config.file_to_copy = "run.sh"
    # Vestigial model-config fields kept for flag-surface parity
    # (reference config.py:94,118 — set but never consumed by the models).
    config.layers = [1, 1, 2, 4]

    # Hostname-based local override (reference config.py:98-115).
    if socket.gethostname() in ["hemingway"]:
        print("Running in local machine")
        config.models_path = f"./__train/{config.version}/"
        if config.model_weights is not None:
            config.model_weights = config.model_weights.replace(
                "../", f"/mnt/Data/SSHFS/{config.local_server_name}/GA_SEG/")
        config.batch_size = 1
        config.gpus = [0]
        config.split_indices = [0]
        config.virtual_batch_size = 1
        config.threads = 1
        config.force_mem_cache_release = "ReleaseMemCache"
        config.layers = [1, 1, 1, 1]
        config.multiplier = 1

    config.number_of_channels = [int(32 * 1 * 2 ** i)
                                 for i in range(0, len(config.layers))]
    return config


def parse_config(argv: Optional[Sequence[str]] = None,
                 parser: Optional[argparse.ArgumentParser] = None,
                 known_only: bool = True):
    """Parse CLI flags into a config namespace with derived fields."""
    parser = parser or build_parser()
    if known_only:
        config, _ = parser.parse_known_args(argv)
    else:
        config = parser.parse_args(argv)
    return derive(config)


def make_config(**overrides) -> SimpleNamespace:
    """Build a config programmatically (tests / library use).

    Required keys mirror the CLI: ``training_dataset`` and ``model``.
    """
    argv: List[str] = ["--training-dataset",
                       overrides.pop("training_dataset", "hrf"),
                       "--model", overrides.pop("model", "FPN")]
    config, _ = build_parser().parse_known_args(argv)
    for k, v in overrides.items():
        if not hasattr(config, k):
            raise KeyError(f"Unknown config field: {k}")
        setattr(config, k, v)
    return derive(config)


def pretty_print(config) -> str:
    lines = ["-" * 80, "[config]"]
    for k, v in sorted(vars(config).items()):
        lines.append(f"{k}: {v}")
    lines.append("-" * 80)
    return "\n".join(lines)
