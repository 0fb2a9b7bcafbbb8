"""Pyramid constants of ``ModifiedUnet3D`` (``multimodal_fusion_fpn_tpu/
models/unet3d.py:24-26``), shared by the hybrid fusion net.  The 3D-only
net itself is not ported yet."""

POOLS_3D = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2))
UPFACTORS = ((2, 2, 1), (2, 2, 1), (1, 2, 1), (1, 2, 1))
NUM_REDUCTIONS = (4, 3, 2, 1, 0)
