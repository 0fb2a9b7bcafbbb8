"""Architecture hyper-parameter spec, read from an ini file.

The port's own copy of ``multimodal_fusion_fpn_tpu/models/arch_config.py``
and of its ini (``configs/``): channel widths per pyramid level, one
dropout slot per block, batch-norm and deconv toggles, with the same keys
as the original PyTorch project's ini (``fusion_nets.py:21-26``).
"""

import configparser
import dataclasses
import os
from typing import Optional, Tuple

_DEFAULT_INI = "modifiedUnet3D_red-convPlusFully_dropout00"


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256)
    dropout: Tuple[float, ...] = (0.0,) * 9
    is_batchnorm: bool = True
    is_deconv: bool = False
    name: str = "ModifiedUnet3D"

    def __post_init__(self):
        assert len(self.channels) == 5, self.channels
        assert len(self.dropout) == 9, self.dropout


def load_arch_spec(config_filename: str = _DEFAULT_INI,
                   search_dir: Optional[str] = None) -> ArchSpec:
    """Load an :class:`ArchSpec` from an ini file.

    Looks in ``search_dir`` if given, else in the packaged ``configs/``
    directory (same keys as the reference ini).
    """
    if search_dir is None:
        search_dir = os.path.join(os.path.dirname(__file__), "configs")
    path = os.path.join(search_dir, config_filename + ".ini")
    parser = configparser.ConfigParser()
    read = parser.read(path)
    if not read:
        raise FileNotFoundError(path)
    sec = parser["architecture"]
    return ArchSpec(
        channels=tuple(int(c) for c in sec.get("channels").split(",")),
        dropout=tuple(float(d) for d in sec.get("dropout").split(",")),
        is_batchnorm=sec.getboolean("is-batchnorm"),
        is_deconv=sec.getboolean("is-deconv"),
        name=sec.get("architecture-name"),
    )
