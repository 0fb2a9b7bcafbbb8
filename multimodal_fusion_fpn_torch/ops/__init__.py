"""Ops of the port: plain tensor functions and the hand-written kernels.

Each kernel module (``fused_conv``, ``pool``, ``fused_block``,
``banded_conv``) keeps a plain-integer launch count per kernel and the call
shapes those launches ran at; :func:`kernel_launches` reads the counts and
:func:`reset_launches` sets them to zero.
"""

from typing import Dict

from multimodal_fusion_fpn_torch.ops import (banded_conv, fused_block,
                                             fused_conv, pool)

KERNEL_MODULES = (fused_conv, pool, fused_block, banded_conv)


def kernel_launches() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for mod in KERNEL_MODULES:
        out.update(mod.launches)
    return out


def reset_launches() -> None:
    for mod in KERNEL_MODULES:
        for name in mod.launches:
            mod.launches[name] = 0
        mod.calls.clear()
