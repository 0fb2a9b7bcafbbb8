#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. Build the CUDA kernels from ``multimodal_fusion_fpn_torch/csrc``
   (``nvcc`` for sm_90a, one process per source, in parallel) and print
   the card's name and power limit.  Count the ``HMMA`` (tensor-core)
   instructions of each kernel of the bf16 forward
   (``csrc/fused_conv_mma.cu``, all FWD_MMA_INSTANCES of them), the bf16
   backward (``csrc/fused_conv_bwd_mma.cu``) and the bf16 whole-block
   kernel (``csrc/fused_block_mma.cu``, all K8_MMA_INSTANCES) in its SASS
   (``cuobjdump --dump-sass``); a kernel without one fails the run.
2. Eval kernels (K1, K2, K5f) against their plain PyTorch versions, on
   the card, at every call shape of one member's eval forward at each of
   the two configurations below.  fp32 runs with TF32 off and must agree
   to max-abs-err <= 1e-4 * max|y|; bf16 by cosine >= 0.999 and a norm
   ratio within 1%.  Each shape prints a JSON line with the kernel's, the
   plain version's and one library call's time (``library_ms``:
   ``F.conv3d`` on the already activated input, or for the pool ``amax``
   on the window view, with ``F.max_pool3d`` beside it; a yardstick only,
   the port never calls it) and the least time the card could take
   (``bound_ms``).  The pool (K5f) is held bit for bit against its plain
   version; its, ``amax``'s and ``F.max_pool3d``'s times are taken on the
   device alone (``device_ms``, in turns), their host-clocked times beside
   them; at the largest pool shape of each configuration NaNs planted at
   the first and last positions of some windows must give NaN exactly
   there and the plain version's bits elsewhere (``nan_control``).  One
   line (``pool_host_path``) gives the host microseconds per call of the
   pool wrapper's pieces at a 2D-stage shape.  The fused conv must give the same output
   twice (bitwise); in bf16 it runs on the tensor cores and is also held
   against its bf16 CUDA-core instance (``tensor_cores=False``), which
   multiplies the same operands: cosine >= 0.99999, y within 2^-7 *
   max|ref| (``same_operands``), the line with that instance's time
   (``cuda_cores_ms``).  The fused conv's times (both instances in turns,
   and cuDNN's) are taken on the device alone (``device_ms``: queued
   behind a long matmul, so the launcher's host time, which exceeds the
   kernel's at the 2D-stage shapes, stays out); ``host_bound_ms`` is the
   launcher timed as the plain versions are.
3. Ensemble, end to end: the 5-member ensemble of FPNHybridFusion at the
   ini widths, seeded weights with seeded non-trivial BatchNorm running
   stats, at the crop shapes (OCT (B, 1, 32, 496, 128), SLO (B, 1, 320, 1,
   128)): bf16 at B=4 and fp32 at B=1.  The kernel path is held against
   ``kernels=False`` on the card, one member's small-input output against
   the CPU, and every eval kernel's launch count must grow.  Images/s come
   from CUDA events: the best of four timings of three steps per path, the
   two paths taken in turns.  One more step per path runs under
   ``torch.profiler`` for the card's busy time and its largest kernels.
4. Train kernels (the stats epilogue of K1/K2, K3 and K4 as dgrad and
   wgrad, K5b) against their plain versions at every call shape of one
   train step at each configuration, with the same tolerances (K5b exact,
   on inputs full of ties, and again with NaNs planted in them: the plain
   version's bits, g at every planted NaN); two runs bitwise equal.  Library calls:
   ``aten.convolution_backward`` (dgrad or wgrad on the activated input)
   and the ``F.max_pool3d`` backward; K5b and that backward timed on the
   device alone (``device_ms``).  In bf16 the stats forward, dgrad
   and wgrad run on the tensor cores; at each of their shapes they are
   also held against the bf16 CUDA-core instance, as in phase 2: cosine
   >= 0.99999 on every output, y / dx / dw within 2^-7 * max|ref|, ds / db
   within 1e-4 * max|ref|, s1 / s2 at their tolerance against plain;
   timed on the device alone as in phase 2.
5. Train, end to end: one ``make_train_step`` (SGD lr 0.1, momentum 0.9,
   weight decay 1e-4, Mix(Dice + BCE)) from the same seeded weights and
   batch on the kernel path, on ``kernels=False`` and, as the reference,
   on ``kernels=False`` at higher precision (fp32 for the bf16 step, fp64
   for the fp32 step).  Kernel path against plain path: the loss (fp32
   relative error <= 1e-5, bf16 <= 1e-2) and the new running stats (fp32
   max-abs-err <= 1e-4 * max|ref| per tensor, bf16 cosine >= 0.999 and
   norm ratio within 1%).  Both paths' updated parameters must be SGD's
   step from their own gradients.  The gradients of both paths against
   the reference (``compare_grads``): fp32 at cosine >= 0.9999 and norm
   ratio within 1e-3 over all of them, each tensor as close or within
   SPREAD_TENSOR times the plain path's distance; bf16, whose gradients
   are mostly rounding noise at these weights, no worse than the plain
   path's within BF16_COS_MARGIN and BF16_RATIO_MARGIN.  Then every
   fused conv block's backward on the kernel path against the plain path
   from the same captured input and output cotangent (``check_blocks``:
   every gradient tensor at fp32 cosine >= 0.9999 and norm ratio within
   1e-3, bf16 cosine >= 0.99 and ratio within 5%, each block's gradients
   concatenated at bf16 cosine >= 0.999 and ratio within 1%), which holds
   the autograd Functions, the stats-cotangent fold, the BatchNorm
   backward and the rounding of dw / ds / db.  The faults in CONTROLS,
   planted in the kernels' backward, must each fail the block check
   (their end-to-end verdicts are printed too).  A per-module trace of
   the plain path's output cotangents against the reference's (cosine)
   shows where the working precision loses the gradient.  One fp32 step
   at the small input against the same step on the CPU: loss and running
   stats as above, gradients as a whole (cosine >= 0.9999, norm ratio
   within 1e-3).  Train images/s and the profiler as in phase 3; every
   train kernel's launch count must grow.
6. Bucketed serving, the default of ``validate_ensemble.py``, at whole
   volumes: true OCT (D, H, W) (48, 496, 176) and en-face (208, 176),
   zero-padded by ``bucket_pad(..., 64)`` to (48, 512, 192) and
   (256, 192); bf16 at B=4 and fp32 at B=1.  (a) K7 (the extents instance
   of the fused conv) against its plain version at every call shape of one
   member's bucketed forward, on inputs random everywhere, so the padding
   holds garbage that a leaking mask would read (the same conv without the
   mask must differ), two runs bitwise equal, in bf16 also against the
   CUDA-core instance, and K5f at the bucketed pool shapes; timings as in
   phase 2, the library call being ``F.conv3d`` on the masked activated
   input.  (b) The 5-member ensemble on the padded batch, cropped to the
   true extent, against the same path on the unpadded batch, the kernel
   path and ``kernels=False`` each: fp32 max-abs-err <= 1e-5 * max|y|,
   bf16 cosine >= 0.9999 and norm ratio within 1% (on the prediction
   centred at 0.5).  The kernel path against ``kernels=False`` on the
   padded batch: fp32 the same; bf16 at phase 3's cosine >= 0.999 and
   norm ratio within 1%, since the same comparison unpadded, printed
   beside it, sits at about 0.9998 (bf16 rounds the kernels' and cuDNN's
   convs at other places; bucketing adds nothing to that).  A planted
   control, extents claiming the padded shape, must fail (b).  (c) The Hausdorff distances fused into the
   step (``with_hd``) against the host scipy path on the card's cropped
   mean prediction, per image (rel. 1e-5, hd95 1e-4, or both NaN).
   (d) Serving rate: ``eval.harness.evaluate`` over 8 images of two true
   shapes (the second (48, 480, 160) with en-face (200, 160), the same
   bucket) at ``eval_batch`` 4, with the HRF metrics (Dice, BCE,
   Precision, Recall, Hausdorff and Hausdorff95 on the device): images/s
   on the kernel path and on ``kernels=False`` (best of two, in turns),
   the card's busy share and its largest kernels.  The launch counts of
   that kernel-path run are K7's.
7. Eval block fusion (K8: ``block_fusion`` "chain", the whole block in
   one kernel, and "pair", two convs in one kernel).  (a) The chain and
   pair kernels against their plain versions at every call shape of one
   member's forward, at the crop shapes and at the bucketed shapes (the
   padding full of garbage, which the unmasked plain version must show),
   with phase 2's tolerances; each shape line has the kernel's time, the
   plain version's (cuDNN per op), the per-conv kernel path's (K1/K2/K7
   on the same block: ``fused_chain_per_conv``), the bf16 CUDA-core K8
   instance's (``cuda_cores_ms``), all on the device alone (``device_ms``)
   with the launcher's ``host_bound_ms``, the bound, the tiling
   (``fb.plan``) and the share of the kernel's work that its halos
   recompute.  (b) On the same inputs, the kernel against the per-conv
   kernel path: bf16 (``csrc/fused_block_mma.cu``) bit-equal to the
   tensor-core per-conv path, the model's; the bf16 CUDA-core K8 instance
   (``fb._launch(..., tensor_cores=False)``) bit-equal to the CUDA-core
   per-conv path (``tensor_cores=False``); fp32 bit-equal to the fp32
   per-conv path; each also at fp32 max-abs-err <= 1e-5 * max|y| or bf16
   cosine >= 0.9999 and norm ratio within 1%.  (c) The 5-member ensemble at the crop shapes, bf16
   B=4 and fp32 B=1, under each fusion against the per-conv kernel path
   (fp32 1e-5 * max|y|, bf16 cosine >= 0.9995 and norm ratio within 1%)
   and against ``kernels=False`` (phase 3's bounds), with the launches
   per member of the CPU routing test (``K8_PER_MEMBER``).  (d) The
   bucketed ensemble under each fusion, cropped, against its unpadded run
   (phase 6's bounds) and the planted wrong-extents control under the
   chain, which must fail.  (e) bf16 images/s of the crop-shape ensemble
   on four paths (plain, per-conv kernels, pair, chain) and the serving
   rate of ``evaluate`` on the same four, with the busy share and the
   largest kernels; the launch counts of the serving runs under "chain"
   and "pair" are the extents instances'.
8. The narrow-entry conv (K10: the ci = 1 first conv and 1x1x1
   downsample of both stage 1s, 4 launches per member forward, and per
   train step 4 forwards and 4 weight gradients, which phases 2-7 check
   among their launch counts).  At every K10 call shape that phases 2, 4
   and 6 recorded (the ensemble's forwards, the train step's forwards and
   weight gradients, the bucketed forwards with extents) and at the data
   gradient's instance of each train shape (ci 16 -> co 1, which the
   train step does not launch: its input is the data), the kernel against
   its plain version: fp32 max-abs-err <= 1e-5 * max|y|, bf16 cosine >=
   0.9999 and norm ratio within 1%; two runs bitwise equal (the weight
   gradient's fixed-order sums); with extents, on inputs random
   everywhere, the garbage beyond them must show in the unmasked plain
   version; the forward (the entry kernel, ci = 1 -> co = 16) also
   bit-equal to the generic forward kernel (``mmf_banded_conv_generic``).
   Each shape line has the kernel's, the plain version's and the library
   call's time (``F.conv3d`` on the masked input, or
   ``aten.convolution_backward``'s weight or input gradient), the kernel's
   and the library call's on the device alone (``device_ms``) with their
   host-clocked times beside them, and the bound.
9. The rest of the zoo (``zoo_phase``), at the ini widths and phase 3's
   crop shapes, seeded weights as in phase 3.  (a) FPN, the model
   ``run.sh`` trains and serves, fed no en-face map: the 5-member
   ensemble at bf16 B=4 and fp32 B=1, kernel path against
   ``kernels=False`` with phase 3's tolerances and images/s, each kernel's
   launches exactly MEMBERS times its per-member count (ZOO_PER_MEMBER)
   and every other kernel's 0; one member's small input against the CPU;
   one train step per configuration checked as in phase 5 (the loss, the
   running stats, SGD's step and ``compare_grads`` against the
   higher-precision plain step), with the train kernels' launches; and
   bucketed serving through ``eval.harness.evaluate`` at phase 6's two
   true shapes (bf16: SERVE_IMAGES images, ``eval_batch`` 4; fp32: one
   image of each shape, ``eval_batch`` 1) against the same run
   unbucketed, each dispatch's prediction within phase 6's bounds, with
   the extents instances' launches and the bucketed run's images/s.  (b)
   One member of FPN2D, FPNLateFusion ('2d_max') and FPNClassification
   (3 classes) at both configurations: kernel path against plain with
   phase 3's tolerances on the prediction minus its value at zero logits,
   the launches per member, the small input against the CPU; FPN2D and
   FPNLateFusion also one bucketed batch (phase 6's shapes) against the
   unpadded one (phase 6's bounds; FPN2D's prediction at the mask's
   shape, uncropped).  (c) Each Regression variant, bf16 B=4 on the
   kernel path: the sigmoid of its output equals its base model's
   prediction bit for bit.
10. The serving entry point (``entry_phase``): the port's
   ``validate_ensemble.run`` over a synthetic HRF tree written by the
   port's ``make_synthetic_hrf`` (ENTRY_VISITS visits of phase 6's first
   true shape), ``FPNHybridFusion`` at the ini widths, ``relative_2d_max``,
   SLO, five seeded members (``member_state_dicts``, each final bias moved
   by minus its median logit on the first visit) written as
   ``epoch=*.ckpt``; each run in its own working directory.  bf16 with
   ``--eval-batch 4 --save-all-outputs``: on the kernels (the launch counts
   must be ENTRY_LAUNCHES exactly), with ``kernels=False`` (the soft
   predictions of ``all_outputs.npz`` held by phase 3's bf16 rule), on the
   kernels again (timed: the entry point's images/s from the call to the
   last artifact, ``evaluate``'s own without the loader's time, the split
   into load + transforms, step, metrics and artifacts) and once more under
   ``torch.profiler`` (the card's busy share).  fp32 on two smaller visits
   on the card and on the CPU: predictions within 1e-4 * max|p|, the metric
   rows at rel 1e-4; the same with the first member's ENTRY_FAULT conv
   zeroed must fail.  Every run's result tree has the same files, and a
   second run of each skips.
11. A ``kernels`` JSON line (per kernel: launches in its path's run, the
   ensemble step for the eval instances, the train step for the training
   kernels, the bucketed serving run for K7 and K10's extents instance and
   the fused runs of phase 7 for K8, and beside them the entry point's
   bf16 run of phase 10, ``launches_entry_point``; max-abs-err of its fp32
   comparisons;
   per-step times summed over the bf16 B=4 calls (for the bucketed paths
   one bucketed ensemble step of 5 members, where the launches count the
   serving run's SERVE_IMAGES / SERVE_BATCH steps), for the tensor-core
   kernels (the fused-conv forward and backward, K8) also the bf16
   CUDA-core instance's (``cuda_cores_ms``), for K5f ``F.max_pool3d``'s
   beside ``amax``'s (``library_ms``), for K10's forward the generic
   kernel's (``generic_ms``); the data gradient of
   K10, off the path, with 0 launches and ``on_main_path`` false), the
   card line, and last the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, without CUDA or without the package.
"""

import collections
import contextlib
import io
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

PEAK_BYTES_PER_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12,          # dense bf16 tensor cores
              "torch.float32": 67e12}            # fp32 outside tensor cores
CUDA_CORE_FLOPS = PEAK_FLOPS["torch.float32"]    # fp32 FMA units, any type
MEMBERS = 5
LR = 0.1
WD = 1e-4                # train.optim.sgd's weight decay
# fp32 train step: how much farther from the fp64 reference one gradient
# tensor of the kernel path may be than the plain path's (phase 5)
SPREAD_TENSOR = 3.0
# bf16 train step: how much lower the kernel path's cosine to the fp32
# reference may be than the plain path's, and how much farther from 1 its
# norm ratio (all gradients concatenated; phase 5)
BF16_COS_MARGIN = 0.05
BF16_RATIO_MARGIN = 0.05
# Faults planted in the kernel path's backward, each of which phase 5 must
# report
CONTROLS = ("zeroed dw", "dropped stats cotangent", "dropped ds")
OCT_YZX = (32, 496, 128)
SLO_HW = (320, 128)
# bucketed serving (phase 6): two true whole-volume shapes, (D, H, W) and
# en-face (H, W), that pad to one bucket
SERVE_OCT = ((48, 496, 176), (48, 480, 160))
SERVE_SLO = ((208, 176), (200, 160))
BUCKET = 64
SERVE_IMAGES = 8
SERVE_BATCH = 4
SPACING = (0.12, 0.0039, 0.0117)   # mm per (D, H, W) voxel
_FC = "multimodal_fusion_fpn_torch/csrc/fused_conv.cu"
_FCM = "multimodal_fusion_fpn_torch/csrc/fused_conv_mma.cu"
_FCB = "multimodal_fusion_fpn_torch/csrc/fused_conv_bwd.cu"
_FCBM = "multimodal_fusion_fpn_torch/csrc/fused_conv_bwd_mma.cu"
_POOL = "multimodal_fusion_fpn_torch/csrc/pool.cu"
_FB = "multimodal_fusion_fpn_torch/csrc/fused_block.cu"
_FBM = "multimodal_fusion_fpn_torch/csrc/fused_block_mma.cu"
_BC = "multimodal_fusion_fpn_torch/csrc/banded_conv.cu"
_TPU_FC = "multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py"
_TPU_POOL = "multimodal_fusion_fpn_tpu/ops/pallas/pool.py"
_TPU_BC = "multimodal_fusion_fpn_tpu/ops/pallas/banded_conv.py"
# name -> (source, the TPU kernel it replaces, the step whose run counts)
KERNELS = {
    "fused_conv": (_FCM, f"{_TPU_FC}:375", "ensemble"),
    "fused_conv_ky3": (_FCM, f"{_TPU_FC}:2580", "ensemble"),
    "max_pool3d_cl": (_POOL, f"{_TPU_POOL}:117", "ensemble"),
    "fused_conv_stats": (_FCM, f"{_TPU_FC}:375", "train"),
    "fused_conv_ky3_stats": (_FCM, f"{_TPU_FC}:2580", "train"),
    "fused_conv_dgrad": (_FCBM, f"{_TPU_FC}:2034", "train"),
    "fused_conv_wgrad": (_FCBM, f"{_TPU_FC}:1855", "train"),
    "fused_conv_ky3_dgrad": (_FCBM, f"{_TPU_FC}:2721", "train"),
    "fused_conv_ky3_wgrad": (_FCBM, f"{_TPU_FC}:2880", "train"),
    "max_pool3d_cl_bwd": (_POOL, f"{_TPU_POOL}:132", "train"),
    "fused_conv_dyn": (_FCM, f"{_TPU_FC}:445", "bucketed"),
    "fused_conv_dyn_ky3": (_FCM, f"{_TPU_FC}:2594", "bucketed"),
    "fused_chain": (_FBM, f"{_TPU_FC}:1445", "chain"),
    "fused_pair": (_FBM, f"{_TPU_FC}:1294", "pair"),
    "fused_chain_dyn": (_FBM, f"{_TPU_FC}:1445", "bucketed_chain"),
    "fused_pair_dyn": (_FBM, f"{_TPU_FC}:1294", "bucketed_pair"),
    "banded_conv": (_BC, f"{_TPU_BC}:66", "ensemble"),
    "banded_conv_dyn": (_BC, f"{_TPU_BC}:66", "bucketed"),
    "banded_conv_wgrad": (_BC, f"{_TPU_BC}:66", "train"),
    "banded_conv_dgrad": (_BC, f"{_TPU_BC}:66", "train"),
}
# the fused-conv kernels: bf16 (the main path's) on the tensor cores, fp32
# on the CUDA cores; the TPU kernels each one stands for
FWD_INSTANCES = {"bf16": _FCM, "fp32": _FC}
BWD_INSTANCES = {"bf16": _FCBM, "fp32": _FCB}
# instances of the bf16 forward kernel: 5 tap sets x 3 channel blocks (16,
# 32, 64 output channels) x with and without stats
FWD_MMA_INSTANCES = 30
# the whole-block kernel (K8): bf16 on the tensor cores, fp32 (and the bf16
# CUDA-core instance, ``tensor_cores=False``) on the CUDA cores; its bf16
# instances: 16, 32, 64 output channels x 2 or 3 convs
K8_INSTANCES = {"bf16": _FBM, "fp32": _FB}
K8_MMA_INSTANCES = 6
TC_ROWS = {"fused_conv": "K1 (and K9 _rf_kernel)",
           "fused_conv_ky3": "K2",
           "fused_conv_stats": "K1 with_stats (and K9)",
           "fused_conv_ky3_stats": "K2 with_stats",
           "fused_conv_dyn": "K7 (K1 with_dyn)",
           "fused_conv_dyn_ky3": "K7 (K2 with_dyn)",
           "fused_conv_dgrad": "K3 dx, ds, db (and K9 _rf_dx_kernel)",
           "fused_conv_wgrad": "K6 / K3 band cotangent (and K9)",
           "fused_conv_ky3_dgrad": "K4 dx, ds, db",
           "fused_conv_ky3_wgrad": "K6 _yck_dband_kernel / K4 band"}
# checked at the train shapes, but not launched by the train step: the
# data gradient of the narrow convs, whose input is the data
OFF_PATH = ("banded_conv_dgrad",)
TRAIN_KERNELS = [k for k, v in KERNELS.items()
                 if v[2] == "train" and k not in OFF_PATH]
# K10 launches per member forward (eval), and per train step (forward,
# weight gradient, data gradient): the narrow first conv and 1x1x1
# downsample of the 3D and the 2D stage 1 (tests/test_torch_banded.py)
K10_PER_MEMBER = 4
K10_PER_TRAIN_STEP = {"banded_conv": 4, "banded_conv_wgrad": 4,
                      "banded_conv_dgrad": 0}
# the records of each path's kernel checks carry this tag prefix
RECORD_PREFIX = {"bucketed": "bucketed_", "chain": "k8_", "pair": "k8_",
                 "bucketed_chain": "k8_", "bucketed_pair": "k8_"}
K8_MODES = ("chain", "pair")
# launches per member under each block fusion (the CPU routing test,
# tests/test_torch_fused_block.py)
K8_PER_MEMBER = {"chain": {"fused_chain": 5, "fused_conv": 23,
                           "fused_conv_ky3": 3,
                           "banded_conv": K10_PER_MEMBER},
                 "pair": {"fused_pair": 5, "fused_conv": 25,
                          "fused_conv_ky3": 6,
                          "banded_conv": K10_PER_MEMBER}}

# phase 9: the rest of the zoo.  Kernel launches per member forward at the
# ini widths (the CPU routing test, tests/test_torch_model.py, counts the
# same wrapper calls): FPN is the hybrid's 3D half, FPN2D its 2D half,
# FPNLateFusion both, FPNClassification the 3D encoder alone; every other
# kernel launches 0 times in eval
ZOO_PER_MEMBER = {
    "FPN": {"fused_conv": 22, "fused_conv_ky3": 3, "max_pool3d_cl": 4,
            "banded_conv": 2},
    "FPN2D": {"fused_conv": 13, "fused_conv_ky3": 3, "max_pool3d_cl": 4,
              "banded_conv": 2},
    "FPNLateFusion": {"fused_conv": 35, "fused_conv_ky3": 6,
                      "max_pool3d_cl": 8, "banded_conv": 4},
    "FPNClassification": {"fused_conv": 13, "fused_conv_ky3": 3,
                          "max_pool3d_cl": 4, "banded_conv": 2}}
# FPNClassification with one class would softmax to 1 everywhere
ZOO_CLASSES = {"FPNClassification": 3}
ZOO_REGRESSION = (("FPNRegression", "FPN"),
                  ("FPNHybridFusionRegression", "FPNHybridFusion"),
                  ("FPNLateFusionRegression", "FPNLateFusion"))
# the images of phase 9's fp32 serving check (one of each true shape)
ZOO_FP32_SERVE_IMAGES = 2

# phase 10: the serving entry point over synthetic HRF trees.  The bf16
# tree: ENTRY_VISITS visits of phase 6's first true shape, which bucket to
# OCT (48, 512, 192) and en-face (256, 192); the fp32 tree: two smaller
# visits, both modalities padded (OCT (16, 120, 48) -> (16, 128, 48),
# en-face (72, 48) -> (80, 48)), small enough for the CPU run
ENTRY_VISITS = 8
ENTRY_OCT, ENTRY_SLO = SERVE_OCT[0], SERVE_SLO[0]
ENTRY_SMALL_VISITS = 2
ENTRY_SMALL_OCT, ENTRY_SMALL_SLO = (16, 120, 48), (72, 48)
ENTRY_BATCH = 4
# launches of one bf16 run: 2 dispatches of 4 images x 5 members x (35 K7
# (1,3,3), 6 K7 (3,1,1), 8 K5f, 4 K10 with extents); every other kernel 0
ENTRY_LAUNCHES = {"fused_conv_dyn": 350, "fused_conv_dyn_ky3": 60,
                  "max_pool3d_cl": 80, "banded_conv_dyn": 40}
# the conv that the planted fault zeroes in the first member (a stage-2
# conv of the 3D net, on the kernel path)
ENTRY_FAULT = "resensnet.conv2.0.convBlock.1.0.weight"


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, warm=2):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_BUSY = []


def device_ms(fn, reps=10, warm=2):
    """Device time per call: the calls are queued behind a long matmul, so
    the host's launch time stays out of the timed window (at the small
    2D-stage shapes a launch's host time exceeds the kernel's)."""
    import torch
    for _ in range(warm):
        fn()
    if not _BUSY:
        g = torch.Generator(device="cuda").manual_seed(1)
        _BUSY.append(torch.randn(6144, 6144, generator=g, device="cuda"))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _BUSY[0] @ _BUSY[0]
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(y, ref, dtype):
    """(ok, stats): fp32 by max-abs-err <= 1e-4 * max|ref|, bf16 by
    cosine >= 0.999 and norm ratio within 1%."""
    import torch
    y, ref = y.double(), ref.double()
    err = (y - ref).abs().max().item()
    peak = ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        y.flatten(), ref.flatten(), dim=0).item()
    ratio = (y.norm() / ref.norm()).item()
    finite = bool(torch.isfinite(y).all())
    if dtype == torch.float32:
        ok = finite and err <= 1e-4 * peak
    else:
        ok = finite and cos >= 0.999 and abs(ratio - 1) <= 0.01
    return ok, dict(max_err=err, max_ref=peak, cos=cos, norm_ratio=ratio)


def compare_all(pairs, dtype):
    """compare() over named (got, ref) pairs: (ok, per-name stats, the
    largest max_err)."""
    stats, ok = {}, True
    for name, got, ref in pairs:
        o, st = compare(got, ref, dtype)
        ok &= o
        stats[name] = st
    return ok, stats, max(st["max_err"] for st in stats.values())


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dtype(dts):
    import torch
    return getattr(torch, dts.split(".")[1])


def conv_inputs(xs, ws, affine, dt, gen):
    import torch
    x = torch.randn(xs, generator=gen, device="cuda").to(dt)
    s = b = None
    if affine:
        s = (0.5 + torch.rand(xs[-1], generator=gen, device="cuda")).to(dt)
        b = (0.5 * torch.randn(xs[-1], generator=gen, device="cuda")).to(dt)
    fan_in = ws[0] * ws[1] * ws[2] * ws[3]
    w = (torch.randn(ws, generator=gen, device="cuda") / fan_in ** 0.5).to(dt)
    return x, s, b, w


def conv_cost(xs, ws, sz, esize, affine):
    """(bytes, flops) of one forward: x, w (and scale, bias) read, y
    written; 2 * outputs * taps * ci flops."""
    zo = (xs[3] - 1) // sz + 1
    n_out = xs[0] * xs[1] * xs[2] * zo * ws[4]
    nbytes = (int(np.prod(xs)) + int(np.prod(ws)) + n_out) * esize
    if affine:
        nbytes += 2 * xs[-1] * esize
    return nbytes, 2.0 * n_out * ws[0] * ws[1] * ws[2] * ws[3], n_out


def cuda_core_ms(nbytes, flops):
    return max(nbytes / PEAK_BYTES_PER_S, flops / CUDA_CORE_FLOPS) * 1e3


def same_operands(pairs):
    """(ok, per-name stats): a tensor-core kernel against its bf16
    CUDA-core instance, which multiplies the same bf16 operands and sums in
    another order: cosine >= 0.99999 on every output; y / dx / dw within
    2^-7 * max|ref|, ds / db within 1e-4 * max|ref|, s1 / s2 at their
    tolerance against plain as well (norm ratio within 1%)."""
    import torch
    ok, stats = True, {}
    for name, got, ref in pairs:
        got, ref = got.double(), ref.double()
        cos = torch.nn.functional.cosine_similarity(
            got.flatten(), ref.flatten(), dim=0).item()
        err, peak = (got - ref).abs().max().item(), ref.abs().max().item()
        ratio = (got.norm() / ref.norm()).item()
        if name in ("s1", "s2"):
            o = cos >= 0.99999 and abs(ratio - 1) <= 0.01
        else:
            tol = 2 ** -7 if name in ("y", "dx", "dw") else 1e-4
            o = cos >= 0.99999 and err <= tol * peak
        ok &= o
        stats[name] = dict(cos=cos, max_err=err, max_ref=peak,
                           norm_ratio=ratio, ok=o)
    return ok, stats


def instance_record(run, names, got, dt, source):
    """(ok, record) at one kernel call: ``run(tc)`` launches the kernel
    (``tc`` False: its bf16 CUDA-core instance) and returns its outputs.
    In bf16 (the tensor cores) the outputs ``got`` are held against the
    CUDA-core instance's (``same_operands``).  Times on the device alone
    (``device_ms``: queued behind a long matmul, so the launcher's host
    time, which exceeds the kernel's at the 2D-stage shapes, stays out),
    the two instances in turns; ``host_bound_ms`` is the launcher timed as
    ``time_ms`` times the plain versions."""
    import torch
    tc = dt == torch.bfloat16
    ok, rec = True, {}
    if tc:
        ok, st = same_operands(
            [(n, a, c) for n, a, c in zip(names, got, run(False))
             if a is not None])
        rec = dict(vs_cuda_cores_ok=ok, vs_cuda_cores=st)
    times = {True: [], False: []}
    for inst in ((True, False, False, True) if tc else (True,)):
        times[inst].append(device_ms(lambda: run(inst)))
    rec.update(tensor_cores=tc, source=source["bf16" if tc else "fp32"],
               kernel_ms=min(times[True]),
               cuda_cores_ms=min(times[False]) if tc else None,
               host_bound_ms=time_ms(lambda: run(True)))
    return ok, rec


def conv_library(x, s, b, w, relu, sz, ext=None):
    """One cuDNN call computing the conv on the activated (and, with
    ``ext``, masked) input: F.conv3d, timed on the device alone."""
    import torch.nn.functional as F
    from multimodal_fusion_fpn_torch.ops import fused_conv as fc
    from multimodal_fusion_fpn_torch.ops.dynamic_extent import mask_valid
    t = fc.affine_relu(x, s, b, relu)
    if ext is not None:
        t = mask_valid(t, dict(zip((1, 2, 3), ext)))
    t = t.permute(0, 4, 1, 2, 3)
    wl = w.permute(4, 3, 0, 1, 2).contiguous()
    pad = tuple(k // 2 for k in w.shape[:3])
    return device_ms(lambda: F.conv3d(t, wl, stride=(1, 1, sz), padding=pad))


def check_conv_shape(key, n_calls, gen):
    """Kernel vs plain (vs F.conv3d) at one recorded fused_conv call; two
    runs bitwise equal; in bf16 also vs the CUDA-core instance."""
    import torch
    from multimodal_fusion_fpn_torch.ops import fused_conv as fc
    name, xs, ws, sz, relu, affine, _, dts = key[:8]
    dt = _dtype(dts)
    x, s, b, w = conv_inputs(xs, ws, affine, dt, gen)
    run = lambda tc=True: (fc._launch_forward(x, s, b, w, relu, sz, False,
                                              tensor_cores=tc),)
    y = fc.fused_conv(x, s, b, w, relu, sz)
    ok, stats = compare(y, fc.fused_conv_plain(x, s, b, w, relu, sz), dt)
    same = torch.equal(y, run()[0])
    ok_c, rec = instance_record(run, ("y",), (y,), dt, FWD_INSTANCES)
    nbytes, flops, _ = conv_cost(xs, ws, sz, x.element_size(), affine)
    b_ms, b_by = bound(nbytes, flops, dts)
    return dict(kernel=name, dtype=dts, x=list(xs), w=list(ws), stride_z=sz,
                relu=relu, affine=affine, calls_per_step=n_calls,
                flop=flops, bytes=nbytes,
                bound_cuda_cores_ms=cuda_core_ms(nbytes, flops), **rec,
                plain_ms=time_ms(
                    lambda: fc.fused_conv_plain(x, s, b, w, relu, sz)),
                library_ms=conv_library(x, s, b, w, relu, sz),
                bound_ms=b_ms, bound_by=b_by, ok=ok and same and ok_c,
                bitwise_repeatable=same, **stats)


def check_dyn_shape(key, n_calls, gen):
    """K7 vs its plain version at one recorded extents call; two runs
    bitwise equal; in bf16 also vs the CUDA-core instance.  The input is
    random everywhere, so the padding beyond the extents holds garbage: the
    same conv without the mask must differ from the plain version, unless
    the extents cover the whole input."""
    import torch
    from multimodal_fusion_fpn_torch.ops import fused_conv as fc
    name, xs, ws, sz, relu, affine, _, dts, ext = key
    dt = _dtype(dts)
    x, s, b, w = conv_inputs(xs, ws, affine, dt, gen)
    run = lambda tc=True: (fc._launch_forward(x, s, b, w, relu, sz, False,
                                              ext, tensor_cores=tc),)
    plain = lambda: fc.fused_conv_dyn_plain(x, s, b, w, relu, sz, ext)
    y = fc.fused_conv(x, s, b, w, relu, sz, dyn_extents=ext)
    ok, stats = compare(y, plain(), dt)
    same = torch.equal(y, run()[0])
    ok_c, rec = instance_record(run, ("y",), (y,), dt, FWD_INSTANCES)
    whole = tuple(ext) == tuple(xs[1:4])
    unmasked_ok = compare(fc.fused_conv_plain(x, s, b, w, relu, sz),
                          plain(), dt)[0]
    garbage_shows = whole or not unmasked_ok
    nbytes, flops, _ = conv_cost(xs, ws, sz, x.element_size(), affine)
    b_ms, b_by = bound(nbytes, flops, dts)
    return dict(kernel=name, dtype=dts, x=list(xs), w=list(ws), stride_z=sz,
                relu=relu, affine=affine, extents=list(ext),
                calls_per_step=n_calls, flop=flops, bytes=nbytes,
                bound_cuda_cores_ms=cuda_core_ms(nbytes, flops), **rec,
                plain_ms=time_ms(plain),
                library_ms=conv_library(x, s, b, w, relu, sz, ext),
                bound_ms=b_ms, bound_by=b_by,
                ok=ok and same and ok_c and garbage_shows,
                bitwise_repeatable=same, garbage_shows=garbage_shows,
                **stats)


def check_stats_shape(key, n_calls, gen):
    """The stats instance: (y, s1, s2) vs plain; s1/s2 also vs the sums
    of the kernel's own y; two runs bitwise equal; in bf16 also vs the
    CUDA-core instance."""
    import torch
    from multimodal_fusion_fpn_torch.ops import fused_conv as fc
    name, xs, ws, sz, relu, affine, _, dts = key[:8]
    dt = _dtype(dts)
    x, s, b, w = conv_inputs(xs, ws, affine, dt, gen)
    run = lambda tc=True: fc._launch_forward(x, s, b, w, relu, sz, True,
                                             tensor_cores=tc)
    y, s1, s2 = fc.fused_conv(x, s, b, w, relu, sz, with_stats=True)
    again = run()
    plain = lambda: fc.fused_conv_plain(x, s, b, w, relu, sz,
                                        with_stats=True)
    ry, r1, r2 = plain()
    o1, st1, err = compare_all((("y", y, ry), ("s1", s1, r1),
                                ("s2", s2, r2)), dt)
    k1, k2 = fc.channel_sums(y)
    o2, st2, _ = compare_all((("s1_own", s1, k1), ("s2_own", s2, k2)),
                             torch.float32)
    same = all(torch.equal(a, c) for a, c in zip((y, s1, s2), again))
    ok_c, rec = instance_record(run, ("y", "s1", "s2"), (y, s1, s2), dt,
                                FWD_INSTANCES)
    nbytes, flops, n_out = conv_cost(xs, ws, sz, x.element_size(), affine)
    flops += 3.0 * n_out
    b_ms, b_by = bound(nbytes, flops, dts)
    return dict(kernel=name, dtype=dts, x=list(xs), w=list(ws), stride_z=sz,
                relu=relu, affine=affine, calls_per_step=n_calls,
                flop=flops, bytes=nbytes,
                bound_cuda_cores_ms=cuda_core_ms(nbytes, flops), **rec,
                plain_ms=time_ms(plain),
                library_ms=conv_library(x, s, b, w, relu, sz),
                bound_ms=b_ms, bound_by=b_by,
                ok=o1 and o2 and same and ok_c, bitwise_repeatable=same,
                max_err=err, **st1, **st2)


def check_bwd_shape(key, n_calls, gen):
    """dgrad (dx, ds, db) or wgrad (dw) vs its plain half, with the stats
    cotangent where the recorded call had it; two runs bitwise equal; in
    bf16 (the tensor cores) also vs the bf16 CUDA-core instance."""
    import torch
    from multimodal_fusion_fpn_torch.ops import fused_conv as fc
    name, xs, ws, sz, relu, affine, stats, dts = key[:8]
    dt = _dtype(dts)
    x, s, b, w = conv_inputs(xs, ws, affine, dt, gen)
    y = fc.fused_conv(x, s, b, w, relu, sz)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(dt)
    cot = None
    if stats:
        cot = (y, torch.randn(ws[4], generator=gen, device="cuda"),
               0.01 * torch.randn(ws[4], generator=gen, device="cuda"))
    args = (x, s, b, w, g, relu, sz, cot)
    dgrad = name.endswith("dgrad")
    launch = fc._launch_dgrad if dgrad else fc._launch_wgrad
    if dgrad:
        run = lambda tc=True: launch(*args, tensor_cores=tc)
        plain = lambda: fc.fused_conv_dgrad_plain(*args)
        names = ("dx", "ds", "db")
        mask = (True, False, False)
    else:
        run = lambda tc=True: (launch(*args, tensor_cores=tc),)
        plain = lambda: (fc.fused_conv_wgrad_plain(*args),)
        names = ("dw",)
        mask = (False, True, False)
    wrap = fc.fused_conv_bwd(*args)  # the public wrapper, both kernels
    got = wrap[:3] if dgrad else wrap[3:]
    ref = plain()
    again = run()
    pairs = [(n, a, r) for n, a, r in zip(names, got, ref) if r is not None]
    ok, st, err = compare_all(pairs, dt)
    same = all(torch.equal(a, c) for a, c in zip(got, again)
               if a is not None)
    ok_c, rec = instance_record(run, names, got, dt, BWD_INSTANCES)
    # library: cuDNN's backward of the plain conv on the activated input
    t = fc.affine_relu(x, s, b, relu).permute(0, 4, 1, 2, 3)
    wl = w.permute(4, 3, 0, 1, 2).contiguous()
    gl = fc._fold_stats_cot(g, cot).permute(0, 4, 1, 2, 3)
    pad = tuple(k // 2 for k in ws[:3])
    lib = lambda: torch.ops.aten.convolution_backward(
        gl, t, wl, None, (1, 1, sz), pad, (1, 1, 1), False, (0, 0, 0), 1,
        mask)
    esize = x.element_size()
    nbytes, flops, n_out = conv_cost(xs, ws, sz, esize, affine)
    # read x, g (and y), w or nothing, scale/bias; write dx (+ ds, db) or dw
    nbytes = (2 * int(np.prod(xs)) if dgrad else int(np.prod(xs))) * esize
    nbytes += n_out * esize * (2 if stats else 1)
    nbytes += int(np.prod(ws)) * esize
    if affine:
        nbytes += 2 * xs[-1] * esize + (2 * xs[-1] * 4 if dgrad else 0)
    b_ms, b_by = bound(nbytes, flops, dts)
    return dict(kernel=name, dtype=dts, x=list(xs), w=list(ws), stride_z=sz,
                relu=relu, affine=affine, stats_cotangent=stats,
                calls_per_step=n_calls, flop=flops, bytes=nbytes,
                bound_cuda_cores_ms=cuda_core_ms(nbytes, flops), **rec,
                plain_ms=time_ms(plain), library_ms=device_ms(lib),
                bound_ms=b_ms, bound_by=b_by, ok=ok and same and ok_c,
                bitwise_repeatable=same, max_err=err, outputs=st)


def same_bits(a, b):
    """NaN at the same places, and the same bits everywhere else."""
    import torch
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    na, nb = a.isnan(), b.isnan()
    return bool(torch.equal(na, nb)) and torch.equal(
        a.masked_fill(na, 0).view(ints[a.dtype]),
        b.masked_fill(nb, 0).view(ints[b.dtype]))


def plant_nan(x, win, gen, every=64):
    """A copy of x with NaN at the first position of about one pooled
    window in ``every`` and at the last position of as many others
    (channels random); and the pooled positions whose window holds one."""
    import torch
    from multimodal_fusion_fpn_torch.ops import pool
    xn = x.clone()
    B, Y, X, Z, C = x.shape
    wy, wx, wz = win
    Yo, Xo, Zo = Y // wy, X // wx, Z // wz
    n = max(1, B * Yo * Xo * Zo * C // every)
    for last in (0, 1):
        idx = [torch.randint(0, m, (n,), generator=gen, device="cuda")
               for m in (B, Yo, Xo, Zo, C)]
        b, oy, ox, oz, c = idx
        xn[b, oy * wy + last * (wy - 1), ox * wx + last * (wx - 1),
           oz * wz + last * (wz - 1), c] = float("nan")
    return xn, pool._windows(xn.isnan(), win).any(dim=(2, 4, 6))


def pool_nan_control(x, win, gen):
    """K5f on x with NaNs planted: NaN exactly at the windows that hold one,
    the plain version's bits everywhere else."""
    from multimodal_fusion_fpn_torch.ops import pool
    xn, want = plant_nan(x, win, gen)
    y = pool.max_pool3d_cl(xn, win)
    ok = bool((y.isnan() == want).all()) and same_bits(
        y, pool.max_pool3d_cl_plain(xn, win))
    return ok, dict(ok=ok, nan_windows=int(want.sum().item()),
                    nan_out=int(y.isnan().sum().item()))


def check_pool_shape(key, n_calls, gen, nan_control=False):
    """K5f against its plain version at one call shape: the same bits; the
    kernel, ``amax`` on the window view (one PyTorch call of the same
    function, the library call) and ``F.max_pool3d`` timed on the device
    alone, in turns, with their host-clocked times beside them; with
    ``nan_control`` also :func:`pool_nan_control`."""
    import torch
    import torch.nn.functional as F
    from multimodal_fusion_fpn_torch.ops import pool
    name, xs, win, dts = key
    dt = _dtype(dts)
    x = torch.randn(xs, generator=gen, device="cuda").to(dt)
    run = lambda: pool.max_pool3d_cl(x, win)
    y = run()
    ref = pool.max_pool3d_cl_plain(x, win)
    exact = same_bits(y, ref)
    nbytes = (x.numel() + y.numel()) * x.element_size()
    b_ms, b_by = bound(nbytes, float(x.numel()), dts)
    xw = pool._windows(x, win)
    xc = x.permute(0, 4, 1, 2, 3)
    fns = {"kernel": run, "amax": lambda: xw.amax(dim=(2, 4, 6)),
           "max_pool3d": lambda: F.max_pool3d(xc, win)}
    dev = {k: [] for k in fns}
    for k in ("kernel", "amax", "max_pool3d", "max_pool3d", "amax",
              "kernel"):
        dev[k].append(device_ms(fns[k]))
    rec = dict(kernel=name, dtype=dts, x=list(xs), window=list(win),
               calls_per_step=n_calls, kernel_ms=min(dev["kernel"]),
               device_ms=min(dev["kernel"]), host_bound_ms=time_ms(run),
               plain_ms=time_ms(lambda: pool.max_pool3d_cl_plain(x, win)),
               library="amax", library_ms=min(dev["amax"]),
               max_pool3d_ms=min(dev["max_pool3d"]),
               amax_host_ms=time_ms(fns["amax"]),
               max_pool3d_host_ms=time_ms(fns["max_pool3d"]),
               bound_ms=b_ms, bound_by=b_by, ok=exact,
               max_err=(y.float() - ref.float()).abs().max().item())
    if nan_control:
        ok_n, rec["nan_control"] = pool_nan_control(x, win, gen)
        rec["ok"] = exact and ok_n
    return rec


def pool_host_path(reps=2000):
    """Host microseconds per call of the pool wrapper's pieces at a 2D-stage
    shape (bf16 (4, 320, 1, 128, 16), window (1, 1, 2)), each timed alone
    over ``reps`` calls: the whole wrapper, its checks, the output's
    allocation (``x.new_empty``, and ``torch.empty`` with dtype and device
    beside it), the current stream's handle (the raw one, and through
    ``torch.cuda.current_stream`` beside it), the loaded entry point, the
    ctypes call (the launch) and the call-shape count."""
    import torch
    from multimodal_fusion_fpn_torch.ops import pool
    x = torch.randn(4, 320, 1, 128, 16, device="cuda").bfloat16()
    win = (1, 1, 2)
    out = pool.max_pool3d_cl(x, win)
    fn = pool._fn("pool", "mmf_max_pool3d", pool._FWD_ARGS)
    shape, dev = tuple(out.shape), x.device
    counter = collections.Counter()

    def count():
        counter[("max_pool3d_cl", tuple(x.shape), win, str(x.dtype))] += 1
    args = (1, x.data_ptr(), out.data_ptr(), 4, 320, 1, 128, 16, 1, 1, 2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pieces = {
        "wrapper": lambda: pool.max_pool3d_cl(x, win),
        "checks": lambda: (pool._check(x, "max_pool3d_cl"),
                           pool._window(win, "max_pool3d_cl")),
        "new_empty": lambda: x.new_empty(shape),
        "torch_empty": lambda: torch.empty(shape, dtype=x.dtype, device=dev),
        "raw_stream": lambda: pool._stream(x),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "entry_point": lambda: pool._fn("pool", "mmf_max_pool3d",
                                        pool._FWD_ARGS),
        "ctypes_launch": lambda: fn(*args, stream),
        "count": count}
    out_us = {}
    for name, f in pieces.items():
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        out_us[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return out_us


def tied(shape, gen, dt):
    """Values on a coarse grid (windows hold exact ties, +0 and -0)."""
    import torch
    v = torch.randint(-2, 3, shape, generator=gen, device="cuda").float()
    flip = torch.rand(shape, generator=gen, device="cuda") < 0.5
    return torch.where(flip, -v, v).to(dt)


def pool_bwd_nan_control(x, g, win, gen):
    """K5b on the tied x with NaNs planted, its y from K5f: the plain
    version's bits, and every planted NaN takes its window's g."""
    from multimodal_fusion_fpn_torch.ops import pool
    xn, _ = plant_nan(x, win, gen)
    y = pool.max_pool3d_cl(xn, win)
    dx = pool.max_pool3d_cl_bwd(xn, y, g, win)
    B, Yo, Xo, Zo, C = y.shape
    wy, wx, wz = win
    region = (slice(None), slice(0, Yo * wy), slice(0, Xo * wx),
              slice(0, Zo * wz))
    gx = g[:, :, None, :, None, :, None].expand(
        B, Yo, wy, Xo, wx, Zo, wz, C).reshape(B, Yo * wy, Xo * wx, Zo * wz, C)
    nan = xn[region].isnan()
    routed = bool((dx[region][nan] == gx[nan]).all())
    ok = same_bits(dx, pool.max_pool3d_cl_bwd_plain(xn, y, g, win)) and routed
    return ok, dict(ok=ok, nan_inputs=int(nan.sum().item()),
                    routed_to_nan=routed)


def check_pool_bwd_shape(key, n_calls, gen):
    """K5b vs its plain version, exact, on an input full of ties; the
    kernel and cuDNN's backward timed on the device alone."""
    import torch
    import torch.nn.functional as F
    from multimodal_fusion_fpn_torch.ops import pool
    name, xs, win, dts = key
    dt = _dtype(dts)
    x = tied(xs, gen, dt)
    y = pool.max_pool3d_cl(x, win)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(dt)
    run = lambda: pool.max_pool3d_cl_bwd(x, y, g, win)
    dx = run()
    ref = pool.max_pool3d_cl_bwd_plain(x, y, g, win)
    exact = same_bits(dx, ref)
    ties = int((dx != 0).sum().item()) > int((g != 0).sum().item())
    ok_n, nan_rec = pool_bwd_nan_control(x, g, win, gen)
    xc = x.permute(0, 4, 1, 2, 3)
    _, idx = F.max_pool3d(xc, win, return_indices=True)
    gc = g.permute(0, 4, 1, 2, 3)
    lib = lambda: torch.ops.aten.max_pool3d_with_indices_backward(
        gc, xc, list(win), list(win), [0, 0, 0], [1, 1, 1], False, idx)
    nbytes = (2 * x.numel() + 2 * y.numel()) * x.element_size()
    b_ms, b_by = bound(nbytes, float(x.numel()), dts)
    k_ms = device_ms(run)
    return dict(kernel=name, dtype=dts, x=list(xs), window=list(win),
                calls_per_step=n_calls, kernel_ms=k_ms, device_ms=k_ms,
                host_bound_ms=time_ms(run),
                plain_ms=time_ms(
                    lambda: pool.max_pool3d_cl_bwd_plain(x, y, g, win)),
                library_ms=device_ms(lib), bound_ms=b_ms, bound_by=b_by,
                ok=exact and ties and ok_n, ties_present=ties,
                nan_control=nan_rec,
                max_err=(dx.float() - ref.float()).abs().max().item())


def check_banded_shape(key, n_calls, gen):
    """Phase 8 at one K10 call: the kernel against its plain version
    (``compare_bucketed``: fp32 1e-5 * max|y|, bf16 cosine >= 0.9999 and
    norm ratio within 1%), two runs bitwise equal, with extents the
    garbage beyond them showing in the unmasked plain version; the times
    of the kernel, the plain version and the library call (``F.conv3d`` on
    the masked input, or cuDNN's weight or data gradient of the conv)."""
    import torch
    import torch.nn.functional as F
    from multimodal_fusion_fpn_torch.ops import banded_conv as bc
    from multimodal_fusion_fpn_torch.ops.dynamic_extent import mask_valid
    name, xs, ws, dts, ext = key
    dt = _dtype(dts)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = rnd(*xs).to(dt)
    n_pos = int(np.prod(xs[:4]))
    taps = int(np.prod(ws[:3]))
    pad = tuple(k // 2 for k in ws[:3])
    conv_bwd = lambda g, inp, w, mask: torch.ops.aten.convolution_backward(
        g, inp, w, None, (1, 1, 1), pad, (1, 1, 1), False, (0, 0, 0), 1,
        mask)
    garbage_shows = True
    if name == "banded_conv_wgrad":
        g = rnd(*xs[:4], ws[4]).to(dt)
        run = lambda: bc.banded_conv_wgrad(x, g, ws)
        plain = lambda: bc.banded_conv_wgrad_plain(x, g, ws)
        wl = torch.empty(ws[4], ws[3], *ws[:3], dtype=dt, device="cuda")
        xl, gl = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        lib = lambda: conv_bwd(gl, xl, wl, (False, True, False))
        nbytes = x.numel() + g.numel() + int(np.prod(ws))
    elif name == "banded_conv_dgrad":
        # x is the output cotangent g, ws the flipped kernel's shape; w is
        # the conv's own kernel (kY, kX, kz, ci, co)
        w = (rnd(*ws[:3], ws[4], ws[3]) / (taps * ws[4]) ** 0.5).to(dt)
        run = lambda: bc.banded_conv_dgrad(x, w)
        plain = lambda: bc.banded_conv_dgrad_plain(x, w)
        inp = torch.empty(xs[0], ws[4], *xs[1:4], dtype=dt, device="cuda")
        wl = w.permute(4, 3, 0, 1, 2).contiguous()
        gl = x.permute(0, 4, 1, 2, 3)
        lib = lambda: conv_bwd(gl, inp, wl, (True, False, False))
        nbytes = x.numel() + w.numel() + n_pos * ws[4]
    else:
        w = (rnd(*ws) / (taps * ws[3]) ** 0.5).to(dt)
        run = lambda: bc.banded_conv(x, w, dyn_extents=ext)
        plain = lambda: bc.banded_conv_plain(x, w, ext)
        t = (x if ext is None else mask_valid(
            x, dict(zip((1, 2, 3), ext)))).permute(0, 4, 1, 2, 3)
        wl = w.permute(4, 3, 0, 1, 2).contiguous()
        lib = lambda: F.conv3d(t, wl, padding=pad)
        nbytes = x.numel() + w.numel() + n_pos * ws[4]
        if ext is not None and tuple(ext) != tuple(xs[1:4]):
            garbage_shows = not compare_bucketed(bc.banded_conv_plain(x, w),
                                                 plain(), dt)[0]
    y = run()
    ok, stats = compare_bucketed(y, plain(), dt)
    same = torch.equal(y, run())
    extra = {}
    if name in ("banded_conv", "banded_conv_dyn"):
        # the entry kernel against the generic kernel: the same bits
        generic = lambda: bc._run(x, w, ext, "mmf_banded_conv_generic")
        extra = dict(generic_equal=same_bits(y, generic()),
                     generic_ms=device_ms(generic))
    nbytes *= x.element_size()
    flops = 2.0 * n_pos * taps * ws[3] * ws[4]
    b_ms, b_by = bound(nbytes, flops, dts)
    k_ms = device_ms(run)
    return dict(kernel=name, dtype=dts, x=list(xs), w=list(ws),
                extents=None if ext is None else list(ext),
                calls_per_step=n_calls, flop=flops, bytes=nbytes,
                bound_cuda_cores_ms=cuda_core_ms(nbytes, flops),
                kernel_ms=k_ms, device_ms=k_ms, host_bound_ms=time_ms(run),
                plain_ms=time_ms(plain), library_ms=device_ms(lib),
                library_host_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                ok=(ok and same and garbage_shows
                    and extra.get("generic_equal", True)),
                bitwise_repeatable=same, garbage_shows=garbage_shows,
                **extra, **stats)


def hmma_counts(lib):
    """{kernel: HMMA instructions in its SASS} for the tensor-core kernels
    of ``lib`` (the bf16 forward, dgrad, wgrad and whole block; ``cuobjdump
    --dump-sass``, from the toolkit beside nvcc), names demangled to their
    template arguments."""
    import os
    import re
    from multimodal_fusion_fpn_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            m2 = re.search(r"((?:fused_conv|fused_block|dgrad|wgrad)"
                           r"_mma_kernel)I"
                           r"((?:L[ib]\d+E)+)", m.group(1))
            args = [] if m2 is None else re.findall(r"L[ib](\d+)E",
                                                    m2.group(2))
            name = None if m2 is None else f"{m2.group(1)}<{','.join(args)}>"
            if name is not None:
                counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


def recorded_calls():
    """What the last run called: each kernel module's ``calls`` by module
    name, and the launch counts under "launches"."""
    from multimodal_fusion_fpn_torch import ops
    out = {m.__name__.rsplit(".", 1)[-1]: dict(m.calls)
           for m in ops.KERNEL_MODULES}
    out["launches"] = ops.kernel_launches()
    return out


def k10_checks(shapes, train_shapes, bucketed_shapes):
    """Phase 8's calls: {(record tag, key): calls per step} from the K10
    calls that phases 2, 4 and 6 recorded (``recorded_calls``), plus the
    data gradient's instance at each weight-gradient shape (one call each:
    what the step would pay if the input needed its gradient)."""
    out = {}
    for tag in shapes:
        for key, n in shapes[tag]["banded_conv"].items():
            out[(tag, key)] = MEMBERS * n
        for key, n in bucketed_shapes[tag]["banded_conv"].items():
            out[("bucketed_" + tag, key)] = MEMBERS * n
        for key, n in train_shapes[tag]["banded_conv"].items():
            out.setdefault((tag, key), n)   # the forwards: the ensemble's
            if key[0] == "banded_conv_wgrad":
                _, xs, ws, dts, _ = key
                dgrad = ("banded_conv_dgrad", tuple(xs[:4]) + (ws[4],),
                         tuple(ws[:3]) + (ws[4], ws[3]), dts, None)
                out[(tag, dgrad)] = 1
    return out


def trace_step(fn):
    """One call of ``fn`` under torch.profiler: the card's busy time (the
    sum of its kernels' durations, ms) and the largest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return busy, [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                  for e in top]


def timed_paths(step, reps=3):
    """Best-of-four step ms per path (kernels True / False), in turns, and
    the profiler's busy time and top kernels per path."""
    times = {}
    for kern in (False, True, True, False) * 2:
        times.setdefault(kern, []).append(
            time_ms(lambda: step(kernels=kern), reps=reps, warm=0))
    busy = {kern: trace_step(lambda: step(kernels=kern))
            for kern in (True, False)}
    return times, busy


def timing_record(times, busy, B):
    return {"step_ms_kernels": min(times[True]),
            "step_ms_plain": min(times[False]),
            "img_per_s_kernels": B * 1e3 / min(times[True]),
            "img_per_s_plain": B * 1e3 / min(times[False]),
            "step_ms_kernels_runs": times[True],
            "step_ms_plain_runs": times[False],
            "device_busy_ms_kernels": busy[True][0],
            "device_busy_ms_plain": busy[False][0],
            "device_busy_share_kernels": busy[True][0] / min(times[True]),
            "device_busy_share_plain": busy[False][0] / min(times[False]),
            "top_device_kernels_kernels": busy[True][1],
            "top_device_kernels_plain": busy[False][1]}


def make_batch(B, seed, yzx=OCT_YZX, slo_hw=SLO_HW):
    rng = np.random.default_rng(seed)
    Y, Z, X = yzx
    H, W = slo_hw
    return {"image": rng.normal(size=(B, 1, Y, Z, X)).astype(np.float32),
            "slo": rng.normal(size=(B, 1, H, 1, W)).astype(np.float32),
            "mask": (rng.random((B, 1, Y, 1, X)) > 0.7).astype(np.float32)}


def serving_batch(B, seed, shape=0):
    """B images of true shape ``SERVE_OCT[shape]`` / ``SERVE_SLO[shape]``
    with a mask and the spacing, in the reference layout (numpy)."""
    batch = make_batch(B, seed, (SERVE_OCT[shape][0], SERVE_OCT[shape][1],
                                 SERVE_OCT[shape][2]), SERVE_SLO[shape])
    batch["spacing"] = np.tile(np.asarray(SPACING), (B, 1))
    return batch


def compare_bucketed(y, ref, dtype, bf16_cos=0.9999):
    """(ok, stats): fp32 by max-abs-err <= 1e-5 * max|ref|, bf16 by cosine
    >= ``bf16_cos`` and norm ratio within 1%."""
    import torch
    _, st = compare(y, ref, dtype)
    if dtype == torch.float32:
        ok = st["max_err"] <= 1e-5 * st["max_ref"]
    else:
        ok = st["cos"] >= bf16_cos and abs(st["norm_ratio"] - 1) <= 0.01
    return bool(ok and torch.isfinite(y).all()), st


def hrf_metrics():
    """The HRF serving metrics (``eval/configs.py:35-45``), the distances
    on the device."""
    from multimodal_fusion_fpn_torch.metrics import streaming as M
    kw = dict(output_key="prediction", target_key="mask")
    return {"Dice": M.Dice(slice=0, **kw), "BCE": M.BCE(slice=0, **kw),
            "Precision": M.Precision(**kw), "Recall": M.Recall(**kw),
            "Hausdorff": M.Hausdorff(slice=0, device=True, **kw),
            "Hausdorff95": M.Hausdorff95(slice=0, device=True, **kw)}


def check_bucketed_ensemble(tag, dt, B, model, sds):
    """Phase 6 (b) and (c) at one configuration: (ok, record)."""
    import torch
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    from multimodal_fusion_fpn_torch.eval.harness import bucket_pad
    from multimodal_fusion_fpn_torch.metrics import streaming as M
    step = make_ensemble_eval_step(model, sds, with_hd=True)
    batch = serving_batch(B, 6)
    model_in = {k: batch[k] for k in ("image", "slo", "mask")}
    padded = bucket_pad(model_in, BUCKET)
    sp = batch["spacing"][:, [0, 2]]
    Y, X = SERVE_OCT[0][0], SERVE_OCT[0][2]

    def pred(b, kernels=True):
        out = step(b, sp, kernels=kernels)
        torch.cuda.synchronize()
        return out["prediction"][:, :, :Y, :, :X].float() - 0.5, out

    pred(padded)
    pred(padded, False)
    got, out = pred(padded)
    plain, _ = pred(padded, False)
    unpadded, _ = pred(model_in)
    plain_unpadded, _ = pred(model_in, False)
    bad = dict(padded, __valid_image__=np.asarray(padded["image"].shape[2:]),
               __valid_enface__=np.asarray(padded["slo"].shape[2::2]))
    control, _ = pred(bad)
    ok_u, st_u = compare_bucketed(got, unpadded, dt)
    ok_pu, st_pu = compare_bucketed(plain, plain_unpadded, dt)
    ok_p, st_p = compare_bucketed(got, plain, dt, bf16_cos=0.999)
    st_kp_unpadded = compare(unpadded, plain_unpadded, dt)[1]
    ok_c, st_c = compare_bucketed(control, unpadded, dt)
    # (c) the fused distances against scipy on the cropped mean prediction
    host = {"Hausdorff": M.Hausdorff(output_key="prediction",
                                     target_key="mask", slice=0),
            "Hausdorff95": M.Hausdorff95(output_key="prediction",
                                         target_key="mask", slice=0)}
    hd_rows, ok_hd = [], True
    for i in range(B):
        one = {k: v[i:i + 1] for k, v in batch.items()}
        p = {"prediction": (got[i:i + 1] + 0.5).cpu().numpy()}
        for name, key, rtol in (("Hausdorff", "__device_hd__", 1e-5),
                                ("Hausdorff95", "__device_hd95__", 1e-4)):
            want = float(host[name].calculate_batch(one, p)[0])
            have = float(out[key][i])
            same = (np.isnan(want) and np.isnan(have)) or (
                abs(have - want) <= rtol * abs(want))
            ok_hd &= bool(same)
            hd_rows.append([i, name, have, want])
    ok = ok_u and ok_pu and ok_p and not ok_c and ok_hd
    return ok, {"phase": "bucketed_e2e", "config": tag, "members": MEMBERS,
                "batch": B, "padded_image": list(padded["image"].shape),
                "padded_slo": list(padded["slo"].shape), "ok": ok,
                "vs_unpadded": dict(st_u, ok=ok_u),
                "plain_vs_plain_unpadded": dict(st_pu, ok=ok_pu),
                "vs_plain": dict(st_p, ok=ok_p),
                "unpadded_kernels_vs_plain": st_kp_unpadded,
                "control_padded_extents": dict(st_c, ok=ok_c),
                "control_caught": not ok_c, "hausdorff_ok": ok_hd,
                "hausdorff_device_vs_host": hd_rows}


def serving_rate(step, card):
    """Phase 6 (d): ``evaluate`` over SERVE_IMAGES images; (record, the
    launch counts of one kernel-path run)."""
    import torch
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.harness import evaluate
    batches = []
    for i in range(SERVE_IMAGES):
        b = serving_batch(1, 100 + i, shape=i * 2 // SERVE_IMAGES)
        b["FileSetId"] = [f"image{i}"]
        batches.append(b)

    def run(kernels):
        t0 = time.time()
        rows, _ = evaluate(lambda b, sp=None: step(b, sp, kernels=kernels),
                           batches, hrf_metrics(), BUCKET, SERVE_BATCH)
        torch.cuda.synchronize()
        return time.time() - t0, rows

    run(True)
    run(False)
    ops.reset_launches()
    _, rows = run(True)
    launches = ops.kernel_launches()
    times = {}
    for kern in (True, False, False, True):
        times.setdefault(kern, []).append(run(kern)[0])
    busy = {kern: trace_step(lambda: run(kern)) for kern in (True, False)}
    best = {k: min(v) for k, v in times.items()}
    return {"phase": "serving", "images": SERVE_IMAGES,
            "eval_batch": SERVE_BATCH, "bucket": BUCKET,
            "true_shapes": [list(o) + list(e)
                            for o, e in zip(SERVE_OCT, SERVE_SLO)],
            "img_per_s_kernels": SERVE_IMAGES / best[True],
            "img_per_s_plain": SERVE_IMAGES / best[False],
            "seconds_kernels_runs": times[True],
            "seconds_plain_runs": times[False],
            "device_busy_ms_kernels": busy[True][0],
            "device_busy_ms_plain": busy[False][0],
            "device_busy_share_kernels": busy[True][0] / 1e3 / best[True],
            "device_busy_share_plain": busy[False][0] / 1e3 / best[False],
            "top_device_kernels_kernels": busy[True][1],
            "top_device_kernels_plain": busy[False][1],
            "rows": [[r["FileSetId"], r["Dice"], r["Hausdorff"],
                      r["Hausdorff95"], r["Area"]] for r in rows],
            "launches": launches, "card": card}, launches


def block_inputs(key, gen):
    """Random inputs of one recorded fused_chain / fused_pair call: (x,
    s_in, b_in, relu0, convs, ds)."""
    import torch
    _, xs, wshapes, final, relu0, entry, dts, _ = key
    dt = _dtype(dts)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    ci, co = xs[-1], wshapes[0][-1]

    def affine(n):
        return ((0.5 + torch.rand(n, generator=gen, device="cuda")).to(dt),
                (0.5 * rnd(n)).to(dt))

    s_in, b_in = affine(ci) if entry else (None, None)
    convs = [((rnd(*ws) / float(np.prod(ws[:4])) ** 0.5).to(dt),
              *affine(co)) for ws in wshapes]
    ds = None
    if final == "res_conv":
        ds = ((rnd(1, 1, 1, ci, co) / ci ** 0.5).to(dt), *affine(co))
    return rnd(*xs).to(dt), s_in, b_in, relu0, convs, ds


def block_cost(xs, wshapes, final, esize):
    """(bytes, flops) of one whole-block call: x, the weights and affines
    read once, y written once; 2 * voxels * taps * ci * co per conv (and
    the 1x1 downsample)."""
    n_vox = int(np.prod(xs[:4]))
    ci, co = xs[-1], wshapes[0][-1]
    flops = sum(2.0 * n_vox * float(np.prod(ws[:4])) * co for ws in wshapes)
    params = sum(int(np.prod(ws)) + 2 * co for ws in wshapes)
    if final == "res_conv":
        flops += 2.0 * n_vox * ci * co
        params += ci * co + 2 * co
    return (n_vox * (ci + co) + params) * esize, flops


def recompute_share(xs, wshapes, tile):
    """The share of the kernel's conv work beyond the block's own: the
    conv-0 halo in x and z, the two halo rows of each y chunk, and the
    windows' overhang past X and Z (``tile`` = (TX, G, smem, blocks, TZ,
    streamed), the plan; the tensor-core kernel computes the halo rows at the
    volume's y edges too)."""
    TX, G, _, _, TZ = tile[:5]
    B, Y, X, Z, ci = xs
    co = wshapes[0][-1]
    ky3 = len(wshapes) == 3
    rows = sum(min(Y, y0 + G + ky3) - max(0, y0 - ky3)
               for y0 in range(0, Y, G))
    tiles = B * -(-X // TX) * -(-Z // TZ)
    done = tiles * (rows * ((TX + 2) * (TZ + 2) * 9 * ci * co
                            + TX * TZ * 9 * co * co)
                    + (Y * TX * TZ * 3 * co * co if ky3 else 0))
    useful = B * Y * X * Z * (9 * ci * co + 9 * co * co
                              + (3 * co * co if ky3 else 0))
    return done / useful - 1


def check_block_shape(key, n_calls, gen):
    """(a) and (b) of phase 7 at one recorded chain or pair call: (b)
    bit-equality to the per-conv kernel path, bf16 on the tensor cores (the
    model's) and the bf16 CUDA-core K8 instance on the CUDA cores, fp32 on
    the CUDA cores; times on the device alone."""
    import torch
    from multimodal_fusion_fpn_torch.ops import fused_block as fb
    name, xs, wshapes, final, _, _, dts, ext = key
    dt = _dtype(dts)
    tc = dt == torch.bfloat16
    x, s_in, b_in, relu0, convs, ds = block_inputs(key, gen)
    if name.startswith("fused_pair"):
        args = (x, s_in, b_in, convs[0][0], convs[0][1], convs[0][2],
                convs[1][0], relu0)
        fns = (fb.fused_pair, fb.fused_pair_plain, fb.fused_pair_per_conv)
        launch_args = (x, s_in, b_in, relu0,
                       [convs[0], (convs[1][0], None, None)], "raw", None)
    else:
        args = (x, s_in, b_in, relu0, convs, final, ds)
        fns = (fb.fused_chain, fb.fused_chain_plain, fb.fused_chain_per_conv)
        launch_args = args
    kname = name[:-4] if name.endswith("_dyn") else name
    run, plain, per_conv = (lambda f=f: f(*args, dyn_extents=ext)
                            for f in fns)
    per_conv_cc = lambda: fns[2](*args, dyn_extents=ext, tensor_cores=False)
    k8_cc = lambda: fb._launch(kname, *launch_args, ext, tensor_cores=False)
    y = run()
    ok, stats = compare(y, plain(), dt)
    same = torch.equal(y, run())
    pc, pcc = per_conv(), per_conv_cc()
    ok_pc, st_pc = compare_bucketed(y, pc, dt)
    eq_pc = torch.equal(y, pc)
    rec_cc = {}
    if tc:
        y_cc = k8_cc()
        eq_cc = torch.equal(y_cc, pcc)
        rec_cc = dict(cuda_cores_bit_equal_to_per_conv_cuda_cores=eq_cc,
                      cuda_cores_ms=device_ms(k8_cc))
    else:
        eq_cc = torch.equal(y, pcc)
    whole = ext is None or tuple(ext) == tuple(xs[1:4])
    garbage_shows = whole or not compare(fns[1](*args), plain(), dt)[0]
    nbytes, flops = block_cost(xs, wshapes, final, x.element_size())
    b_ms, b_by = bound(nbytes, flops, dts)
    tile = fb.plan(x, len(wshapes), wshapes[0][-1], final)
    return dict(kernel=name, dtype=dts, x=list(xs),
                w=[list(w) for w in wshapes], final=final, relu0=relu0,
                affine=s_in is not None,
                extents=None if ext is None else list(ext),
                calls_per_step=n_calls, flop=flops, bytes=nbytes,
                bound_cuda_cores_ms=cuda_core_ms(nbytes, flops),
                tensor_cores=tc, source=K8_INSTANCES["bf16" if tc else "fp32"],
                tile_x=tile[0], tile_z=tile[4], chunk_rows=tile[1],
                smem_bytes=tile[2], blocks=tile[3], weights_streamed=tile[5],
                recompute_share=recompute_share(xs, wshapes, tile),
                kernel_ms=device_ms(run), host_bound_ms=time_ms(run),
                plain_ms=device_ms(plain), per_conv_ms=device_ms(per_conv),
                per_conv_cuda_cores_ms=device_ms(per_conv_cc), **rec_cc,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                ok=ok and same and ok_pc and eq_pc and eq_cc
                and garbage_shows,
                bitwise_repeatable=same, garbage_shows=garbage_shows,
                vs_per_conv=dict(st_pc, ok=ok_pc, bit_equal=eq_pc),
                vs_per_conv_cuda_cores=dict(compare_bucketed(y, pcc, dt)[1],
                                            bit_equal=torch.equal(y, pcc)),
                **stats)


def timed_named(run, paths, reps=3):
    """Best-of-four ms of ``run(**kw)`` per named path (name, kw), the
    paths taken in turns, and the profiler's busy time and top kernels per
    path."""
    times = {}
    order = list(paths) + list(reversed(paths))
    for name, kw in order * 2:
        times.setdefault(name, []).append(
            time_ms(lambda: run(**kw), reps=reps, warm=0))
    busy = {name: trace_step(lambda: run(**kw)) for name, kw in paths}
    return {name: {"ms": min(times[name]), "runs": times[name],
                   "device_busy_ms": busy[name][0],
                   "device_busy_share": busy[name][0] / min(times[name]),
                   "top_device_kernels": busy[name][1]}
            for name, _ in paths}


K8_PATHS = (("plain", {"kernels": False}), ("per_conv", {}),
            ("pair", {"block_fusion": "pair"}),
            ("chain", {"block_fusion": "chain"}))


def k8_ensemble(tag, dt, B, model, sds, card):
    """Phase 7 (c), and (e)'s ensemble rates for bf16: (ok, record, the
    launches of each fused path's step)."""
    import torch
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    step = make_ensemble_eval_step(model, sds)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_batch(B, 1).items() if k != "mask"}

    def pred(**kw):
        out = step(batch, **kw)["prediction"]
        torch.cuda.synchronize()
        return out

    per_conv = pred().float() - 0.5
    plain = pred(kernels=False).float() - 0.5
    ok, rec, launches = True, {}, {}
    for mode in K8_MODES:
        pred(block_fusion=mode)
        ops.reset_launches()
        got = pred(block_fusion=mode)
        launches[mode] = ops.kernel_launches()
        got = got.float() - 0.5
        ok_pc, st_pc = compare_bucketed(got, per_conv, dt, bf16_cos=0.9995)
        ok_p, st_p = compare(got, plain, dt)
        counted = all(launches[mode][k] == MEMBERS * n
                      for k, n in K8_PER_MEMBER[mode].items())
        shape_ok = got.shape == (B, 1, OCT_YZX[0], 1, OCT_YZX[2])
        rec[mode] = {"ok": ok_pc and ok_p and counted and shape_ok,
                     "vs_per_conv": dict(st_pc, ok=ok_pc,
                                         bit_equal=bool(torch.equal(
                                             got, per_conv))),
                     "vs_plain": dict(st_p, ok=ok_p),
                     "launches": launches[mode], "launches_match": counted}
        ok &= rec[mode]["ok"]
    out = {"phase": "k8_e2e", "config": tag, "members": MEMBERS,
           "batch": B, "ok": ok, **rec, "card": card}
    if dt == torch.bfloat16:
        rates = timed_named(lambda **kw: step(batch, **kw), K8_PATHS)
        for r in rates.values():
            r["img_per_s"] = B * 1e3 / r["ms"]
        out["rates"] = rates
    return ok, out, launches


def k8_bucketed(tag, dt, B, model, sds):
    """Phase 7 (d): (ok, record)."""
    import torch
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    from multimodal_fusion_fpn_torch.eval.harness import bucket_pad
    step = make_ensemble_eval_step(model, sds)
    batch = serving_batch(B, 6)
    model_in = {k: batch[k] for k in ("image", "slo")}
    padded = bucket_pad(model_in, BUCKET)
    bad = dict(padded, __valid_image__=np.asarray(padded["image"].shape[2:]),
               __valid_enface__=np.asarray(padded["slo"].shape[2::2]))
    Y, X = SERVE_OCT[0][0], SERVE_OCT[0][2]

    def pred(b, mode):
        out = step(b, block_fusion=mode)["prediction"]
        torch.cuda.synchronize()
        return out[:, :, :Y, :, :X].float() - 0.5

    ok, rec = True, {}
    per_conv = pred(padded, None)
    for mode in K8_MODES:
        got, unpadded = pred(padded, mode), pred(model_in, mode)
        ok_u, st_u = compare_bucketed(got, unpadded, dt)
        rec[mode] = {"vs_unpadded": dict(st_u, ok=ok_u),
                     "vs_per_conv_padded": compare(got, per_conv, dt)[1]}
        ok &= ok_u
        if mode == "chain":
            ok_c, st_c = compare_bucketed(pred(bad, mode), unpadded, dt)
            rec[mode]["control_padded_extents"] = dict(st_c, ok=ok_c)
            rec[mode]["control_caught"] = not ok_c
            ok &= not ok_c
    return ok, {"phase": "k8_bucketed", "config": tag, "batch": B,
                "ok": ok, **rec}


def k8_serving(step, card):
    """Phase 7 (e), serving: ``evaluate`` over SERVE_IMAGES images on the
    four paths; (record, the launches of the chain and pair runs)."""
    import torch
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.harness import evaluate
    batches = []
    for i in range(SERVE_IMAGES):
        b = serving_batch(1, 100 + i, shape=i * 2 // SERVE_IMAGES)
        b["FileSetId"] = [f"image{i}"]
        batches.append(b)

    def run(kernels=True, block_fusion=None):
        t0 = time.time()
        rows, _ = evaluate(
            lambda b, sp=None, **kw: step(b, sp, kernels=kernels, **kw),
            batches, hrf_metrics(), BUCKET, SERVE_BATCH,
            block_fusion=block_fusion)
        torch.cuda.synchronize()
        return time.time() - t0, rows

    for _, kw in K8_PATHS:
        run(**kw)
    launches, dice = {}, {}
    for mode in K8_MODES:
        ops.reset_launches()
        _, rows = run(block_fusion=mode)
        launches[mode] = ops.kernel_launches()
        dice[mode] = [r["Dice"] for r in rows]
    times = {}
    for name, kw in list(K8_PATHS) + list(reversed(K8_PATHS)):
        times.setdefault(name, []).append(run(**kw)[0])
    busy = {name: trace_step(lambda: run(**kw)) for name, kw in K8_PATHS}
    rec = {"phase": "k8_serving", "images": SERVE_IMAGES,
           "eval_batch": SERVE_BATCH, "bucket": BUCKET, "card": card,
           "dice": dice, "launches": launches}
    for name, _ in K8_PATHS:
        best = min(times[name])
        rec[name] = {"img_per_s": SERVE_IMAGES / best,
                     "seconds_runs": times[name],
                     "device_busy_ms": busy[name][0],
                     "device_busy_share": busy[name][0] / 1e3 / best,
                     "top_device_kernels": busy[name][1]}
    return rec, launches


def member_state_dicts(model, n):
    """Seeded weights (the package's init) with seeded non-trivial
    BatchNorm affines and running stats, so no prologue is the identity."""
    import torch
    from multimodal_fusion_fpn_torch.weights import init_state_dict
    out = []
    for seed in range(n):
        sd = {k: v.cpu() for k, v in init_state_dict(model, seed).items()}
        gen = torch.Generator().manual_seed(1000 + seed)
        for k, v in sd.items():
            if k.endswith("running_mean"):
                v.normal_(0.0, 0.5, generator=gen)
            elif k.endswith("running_var"):
                v.uniform_(0.5, 2.0, generator=gen)
            elif k.endswith(".1.weight") and v.dim() == 1:
                v.normal_(1.0, 0.1, generator=gen)
            elif k.endswith(".1.bias"):
                v.normal_(0.0, 0.1, generator=gen)
        out.append(sd)
    return out


class Trainer:
    """One model + optimizer + train step that can restart from a state
    dict, so two paths start from the same weights."""

    def __init__(self, cfg, dtype, device):
        from multimodal_fusion_fpn_torch.losses import (Mix, bce_loss,
                                                         dice_loss_joint)
        from multimodal_fusion_fpn_torch.models.zoo import build_model
        self.model = build_model(cfg, dtype=dtype, device=device)
        self.crit = Mix({"Dice Loss": dice_loss_joint(),
                         "BCE loss": bce_loss()})
        self.device = device

    def reset(self, sd):
        from multimodal_fusion_fpn_torch.train.optim import sgd
        from multimodal_fusion_fpn_torch.train.state import \
            create_train_state
        from multimodal_fusion_fpn_torch.train.step import make_train_step
        opt = sgd(self.model.parameters(), LR)
        self.state = create_train_state(self.model, opt, sd)
        self.step_fn = make_train_step(self.model, opt, self.crit,
                                       device=self.device)

    def step(self, batch, kernels=True):
        return self.step_fn(self.state, batch, kernels=kernels)

    def snapshot(self):
        """(grads, state dict) after a step, fp32 copies."""
        grads = {k: p.grad.detach().float().clone()
                 for k, p in self.model.named_parameters()}
        sd = {k: v.detach().clone()
              for k, v in self.model.state_dict().items()}
        return grads, sd


def _flat(v):
    return v.double().flatten()


def grad_agreement(a, b):
    """(cosine, norm ratio, L2 distance) of two gradient tensors."""
    import torch
    a, b = _flat(a), _flat(b)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    return cos, (a.norm() / b.norm()).item(), (a - b).norm().item()


def _cat(grads, names):
    import torch
    return torch.cat([_flat(grads[k]) for k in names])


def compare_forward(a, b, dtype):
    """What the forward of train step ``a`` determines, against step
    ``b`` (module note, phase 5): the loss, the new running stats and the
    batch counts."""
    import torch
    (aux_a, _, sd_a), (aux_b, _, sd_b) = a, b
    fp32 = dtype == torch.float32
    out = {}
    la, lb = float(aux_a["loss"]), float(aux_b["loss"])
    out["loss"] = [la, lb]
    out["loss_rel_err"] = abs(la - lb) / abs(lb)
    ok = out["loss_rel_err"] <= (1e-5 if fp32 else 1e-2)
    bad, worst = [], 0.0
    for k, v in sd_a.items():
        if k.endswith("num_batches_tracked"):
            if not torch.equal(v, sd_b[k]):
                bad.append([k, v.item(), sd_b[k].item()])
        elif k.endswith(("running_mean", "running_var")):
            o, st = compare(v.float(), sd_b[k].float(),
                            torch.float32 if fp32 else torch.bfloat16)
            worst = max(worst, st["max_err"] / max(st["max_ref"], 1e-30))
            if not o:
                bad.append([k, st])
    out["running_worst_rel_err"] = worst
    out["running_bad"] = bad[:10]
    return ok and not bad, out


def compare_grads(k, p, ref, dtype):
    """Gradients of the kernel path ``k`` and the plain path ``p`` against
    the plain path at higher precision ``ref`` (module note, phase 5).

    fp32: all gradients concatenated at cosine >= 0.9999 and norm ratio
    within 1e-3; each tensor at the same thresholds, or no farther from
    ``ref`` (relative L2 distance) than SPREAD_TENSOR times the plain
    path's, on that tensor or on all gradients, whichever is larger: a
    ReLU whose input lies within fp32 rounding of 0 flips at other places
    on the two paths, and moves every gradient upstream of it.

    bf16: the gradients are mostly rounding noise at these weights (the
    BatchNorm backward cancels most of each cotangent; the JAX package's
    own bf16 step sits at a cosine of about 0.4 from its fp32 step,
    ``tests/test_torch_train.py``).  All gradients concatenated: the kernel
    path's cosine to ``ref`` at least the plain path's minus
    BF16_COS_MARGIN, its norm ratio no farther from 1 than the plain
    path's plus BF16_RATIO_MARGIN.  Each tensor is held by
    ``check_blocks``, from the same inputs and cotangents."""
    import torch
    fp32 = dtype == torch.float32
    names = list(k)
    out = {}
    ck, rk, dk = grad_agreement(_cat(k, names), _cat(ref, names))
    cp, rp, dp = grad_agreement(_cat(p, names), _cat(ref, names))
    level = dp / _cat(ref, names).norm().item()
    out["grad_cos_all_kernels_vs_plain"] = grad_agreement(
        _cat(k, names), _cat(p, names))[0]
    out["grad_all"] = {"kernels": [ck, rk, dk], "plain": [cp, rp, dp],
                       "plain_rel_dist": level}
    if fp32:
        ok = ck >= 0.9999 and abs(rk - 1) <= 1e-3
    else:
        ok = (ck >= cp - BF16_COS_MARGIN
              and abs(rk - 1) <= abs(rp - 1) + BF16_RATIO_MARGIN)
    bad, entries, n_fixed = [], [], 0
    for name in names:
        if not (k[name].any() or ref[name].any()):
            continue  # both exactly zero
        norm = max(_flat(ref[name]).norm().item(), 1e-30)
        ck_, rk_, dk_ = grad_agreement(k[name], ref[name])
        dp_ = grad_agreement(p[name], ref[name])[2]
        fixed = (ck_ >= 0.9999 and abs(rk_ - 1) <= 1e-3) if fp32 \
            else ck_ >= 0.99
        n_fixed += fixed
        entry = [name, dk_ / norm, dp_ / norm]
        entries.append(entry)
        if fp32 and not (fixed or dk_ / norm <= SPREAD_TENSOR * max(
                dp_ / norm, level)):
            bad.append(entry)
    ok = bool(ok) and not bad  # a NaN cosine fails
    out["grad_tensors"] = len(names)
    out["grad_tensors_at_fixed_thresholds"] = n_fixed
    out["grad_worst_rel_dist"] = sorted(entries, key=lambda e: -e[1])[:5]
    out["grad_bad"] = bad[:10]
    return ok, out


def fused_blocks(model):
    """The conv blocks whose convs take the kernels: {name: ConvX}."""
    from multimodal_fusion_fpn_torch.models.blocks import ConvX
    return {n: m for n, m in model.named_modules()
            if isinstance(m, ConvX) and m.fused}


def capture_blocks(tr, batch):
    """Each fused block's input and output cotangent in one plain-path
    forward and backward of the train step's model (no optimizer step)."""
    from multimodal_fusion_fpn_torch.train.step import model_batch
    cap, hooks = {}, []

    def hook(name):
        def fn(mod, inp, out):
            cap[name] = [inp[0].detach(), None]
            out.register_hook(
                lambda g: cap[name].__setitem__(1, g.detach()))
        return fn

    for name, mod in fused_blocks(tr.model).items():
        hooks.append(mod.register_forward_hook(hook(name)))
    try:
        b = model_batch(batch, tr.device)
        tr.model.train()
        tr.crit(b, tr.model(b, kernels=False))[0].backward()
    finally:
        for h in hooks:
            h.remove()
        tr.model.zero_grad(set_to_none=True)
    return cap


def block_grads(mod, x, g, kernels):
    """dx and the parameter gradients of one block's forward and backward
    from input ``x`` and output cotangent ``g``."""
    mod.zero_grad(set_to_none=True)
    xi = x.clone().requires_grad_()
    mod(xi, kernels).backward(g)
    out = {"dx": xi.grad.float()}
    out.update({k: v.grad.float() for k, v in mod.named_parameters()})
    mod.zero_grad(set_to_none=True)
    return out


def _scale_invariant(mod, name):
    """A 1x1 conv weight with one input channel that feeds a train-mode
    BatchNorm: the BatchNorm makes the output invariant to it up to eps,
    so its gradient is the rounding of a cancellation (K10's weight
    gradient on the kernel path, cuDNN's on the plain path)."""
    if not name.endswith(".0.weight"):
        return False
    w = mod.get_parameter(name)
    return w.dim() > 2 and w.shape[1] == 1 and all(k == 1
                                                   for k in w.shape[2:])


def check_blocks(tr, cap, dtype):
    """Each fused block's backward on the kernel path against the plain
    path, from the same captured input and output cotangent: every
    gradient (dx and each parameter's) at fp32 cosine >= 0.9999 and norm
    ratio within 1e-3, bf16 cosine >= 0.99 and norm ratio within 5%; all
    of a block's gradients concatenated at fp32 the same, bf16 cosine >=
    0.999 and norm ratio within 1%.  (ok, per-block records)."""
    import torch
    fp32 = dtype == torch.float32
    one = (0.9999, 1e-3) if fp32 else (0.99, 0.05)
    cat = (0.9999, 1e-3) if fp32 else (0.999, 0.01)
    blocks = fused_blocks(tr.model)
    ok, recs = True, []
    for name, (x, g) in cap.items():
        mod = blocks[name]
        kern = block_grads(mod, x, g, True)
        plain = block_grads(mod, x, g, False)
        worst, bad = [None, 2.0, 0.0], []
        names = [n for n in plain if not _scale_invariant(mod, n)]
        for n in names:
            c, r, _ = grad_agreement(kern[n], plain[n])
            if not (c >= one[0] and abs(r - 1) <= one[1]):
                bad.append([n, c, r])
            if not c >= worst[1]:
                worst = [n, c, r]
        c_all, r_all, _ = grad_agreement(_cat(kern, names),
                                         _cat(plain, names))
        block_ok = not bad and c_all >= cat[0] and abs(r_all - 1) <= cat[1]
        ok &= block_ok
        recs.append({"block": name, "ok": block_ok, "cos_all": c_all,
                     "norm_ratio_all": r_all, "worst": worst,
                     "bad": bad[:5]})
    return ok, recs


@contextlib.contextmanager
def planted(fault):
    """The kernels' backward (``fused_conv.fused_conv_bwd``, which the
    autograd Function calls) with one of CONTROLS planted."""
    import torch
    from multimodal_fusion_fpn_torch.ops import fused_conv as fc
    real = fc.fused_conv_bwd

    def bwd(x, scale, bias, w, g, relu, stride_z=1, stats_cot=None):
        if fault == "dropped stats cotangent":
            stats_cot = None
        dx, ds, db, dw = real(x, scale, bias, w, g, relu, stride_z,
                              stats_cot)
        if fault == "zeroed dw":
            dw = torch.zeros_like(dw)
        if fault == "dropped ds" and ds is not None:
            ds = torch.zeros_like(ds)
        return dx, ds, db, dw

    fc.fused_conv_bwd = bwd
    try:
        yield
    finally:
        fc.fused_conv_bwd = real


@contextlib.contextmanager
def cotangent_trace(model, out, depth=2, sample=1 << 20):
    """Records into ``out`` a strided sample (at most ``sample`` elements,
    fp64) of the output cotangent of every module at most ``depth`` deep
    below the model's children, in the order the backward reaches them."""
    import torch
    hooks = []

    def hook(name):
        def fn(mod, inp, res):
            if torch.is_tensor(res) and res.requires_grad:
                def keep(g):
                    step = max(1, g.numel() // sample)
                    out[name] = g.detach().flatten()[::step].double()
                res.register_hook(keep)
        return fn

    for name, mod in model.named_modules():
        if name and name.count(".") <= depth:
            hooks.append(mod.register_forward_hook(hook(name)))
    try:
        yield out
    finally:
        for h in hooks:
            h.remove()


def check_sgd_update(p0, grads, p1):
    """The updated parameters are SGD's first step (momentum buffer =
    g + wd*p) from the path's own gradients: max-abs-err <= 1e-6 *
    max|new p|."""
    worst = 0.0
    for name, g in grads.items():
        want = p0[name].double() - LR * (g.double() + WD * p0[name].double())
        err = (p1[name].double() - want).abs().max().item()
        worst = max(worst, err / max(want.abs().max().item(), 1e-30))
    return worst <= 1e-6, worst


def compare_whole(a, b):
    """fp32 train step ``a`` against ``b`` on another device: the forward
    (compare_forward) and all gradients concatenated (cosine >= 0.9999,
    norm ratio within 1e-3)."""
    import torch
    ok, out = compare_forward(a, b, torch.float32)
    names = list(a[1])
    cos, ratio, _ = grad_agreement(_cat(a[1], names), _cat(b[1], names))
    out.update(grad_cos_all=cos, grad_norm_ratio_all=ratio)
    return ok and cos >= 0.9999 and abs(ratio - 1) <= 1e-3, out


def zoo_cfg(name):
    return SimpleNamespace(model=name, crop="relative_2d_max",
                           fusion_modality="slo",
                           number_of_outputs=ZOO_CLASSES.get(name, 1))


def zoo_centred(name, pred):
    """A prediction minus its value at zero logits (the sigmoid's 0.5, the
    softmax's 1 / n), so a cosine compares what the model computed."""
    return pred.float() - 1.0 / ZOO_CLASSES.get(name, 2)


def zoo_batch(name, B, seed, yzx=OCT_YZX, slo_hw=SLO_HW):
    """``make_batch`` on the card, without the en-face map for the models
    that take none (FPN must not need it) and without the mask where the
    model does not read it."""
    import torch
    b = make_batch(B, seed, yzx, slo_hw)
    if name in ("FPN", "FPNRegression", "FPNClassification"):
        del b["slo"]
    if name != "FPN2D":
        del b["mask"]
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def zoo_launches_ok(name, launches, n):
    """Every kernel of ``name``'s eval path launched ``n`` times its
    per-member count, every other kernel not at all."""
    want = ZOO_PER_MEMBER[name]
    return all(launches[k] == n * want.get(k, 0) for k in launches)


def zoo_eval(name, tag, dt, B, model, sds, card, timed=False):
    """Phase 9 (a) and (b): the ensemble of ``sds`` (one member or
    MEMBERS) on the kernel path against ``kernels=False`` at the crop
    shapes, with phase 3's tolerances, the launches counted in a run of
    the kernel path alone, and with ``timed`` the images/s of both paths.
    (ok, record)."""
    import torch
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    step = make_ensemble_eval_step(model, sds)
    batch = zoo_batch(name, B, 1)
    step(batch, kernels=False)
    step(batch)
    torch.cuda.synchronize()
    ops.reset_launches()
    pred = step(batch)["prediction"]
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    ref = step(batch, kernels=False)["prediction"]
    torch.cuda.synchronize()
    ok, stats = compare(zoo_centred(name, pred), zoo_centred(name, ref), dt)
    shape = ((B, ZOO_CLASSES[name]) if name in ZOO_CLASSES
             else (B, 1, OCT_YZX[0], 1, OCT_YZX[2]))
    ok &= tuple(pred.shape) == shape
    counted = zoo_launches_ok(name, launches, len(sds))
    rec = {"phase": "zoo_e2e", "model": name, "config": tag,
           "members": len(sds), "batch": B,
           "prediction_shape": list(pred.shape), "ok": ok,
           "launches": launches, "launches_match": counted, "card": card,
           **stats}
    if timed:
        times, busy = timed_paths(
            lambda kernels: step(batch, kernels=kernels))
        rec.update(timing_record(times, busy, B))
    return ok and counted, rec


def zoo_small_vs_cpu(name, sd):
    """One member on the small input, fp32, the card against the CPU's
    plain path (phase 3's check)."""
    import torch
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    cfg = zoo_cfg(name)
    batch = {k: v.cpu() for k, v in
             zoo_batch(name, 1, 2, (8, 64, 32), (80, 32)).items()}
    with torch.inference_mode():
        card = build_model(cfg)
        card.load_state_dict(sd)
        got = card({k: v.cuda() for k, v in batch.items()})["prediction"]
        cpu = build_model(cfg, device="cpu")
        cpu.load_state_dict(sd)
        want = cpu(batch)["prediction"]
    return compare(got.cpu(), want, torch.float32)


def zoo_bucketed(name, tag, dt, B, model, sd):
    """Phase 9 (b): one bucketed batch (phase 6's shapes, both inputs
    padded) against the unpadded one, one member on the kernel path: fp32
    max-abs-err <= 1e-5 * max|y|, bf16 cosine >= 0.9999 and norm ratio
    within 1%; FPN2D's prediction at the mask's shape, uncropped."""
    import torch
    from multimodal_fusion_fpn_torch.eval.harness import bucket_pad
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    step = make_ensemble_eval_step(model, [sd])
    b = serving_batch(B, 6)
    unpadded = {k: b[k] for k in ("image", "slo", "mask")}
    padded = bucket_pad(unpadded, BUCKET)
    Y, X = SERVE_OCT[0][0], SERVE_OCT[0][2]
    got = step(padded)["prediction"]
    ref = step(unpadded)["prediction"]
    torch.cuda.synchronize()
    same_shape = name != "FPN2D" or got.shape == ref.shape
    ok, st = compare_bucketed(zoo_centred(name, got[:, :, :Y, :, :X]),
                              zoo_centred(name, ref), dt)
    return ok and same_shape, {
        "phase": "zoo_bucketed", "model": name, "config": tag, "batch": B,
        "padded_image": list(padded["image"].shape),
        "padded_slo": list(padded["slo"].shape),
        "prediction_shape": list(got.shape), "ok": ok and same_shape, **st}


def zoo_serving(step, dt, n_images, eval_batch, card):
    """Phase 9 (a): FPN's bucketed serving through ``evaluate`` (phase 6's
    two true shapes, no en-face map in the batches) against the same run
    unbucketed: each dispatch's prediction, cropped, within phase 6's
    bounds, the same rows; the launches of the bucketed run; its images/s
    (best of two).  (ok, record)."""
    import torch
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.harness import evaluate
    batches = []
    for i in range(n_images):
        b = serving_batch(1, 100 + i, shape=i * 2 // n_images)
        del b["slo"]
        b["FileSetId"] = [f"image{i}"]
        batches.append(b)
    preds = []

    def run(bucket):
        preds.clear()

        def capture(b, sp=None):
            out = step(b, sp)
            preds.append(out["prediction"])
            return out
        t0 = time.time()
        rows, _ = evaluate(capture, batches, hrf_metrics(), bucket,
                           eval_batch)
        torch.cuda.synchronize()
        return time.time() - t0, rows, list(preds)

    run(BUCKET)
    ops.reset_launches()
    _, rows_b, got = run(BUCKET)
    launches = ops.kernel_launches()
    _, rows_u, ref = run(0)
    ok, worst = len(got) == len(ref), None
    for g, r in zip(got, ref):
        o, st = compare_bucketed(g[:, :, :r.shape[2], :, :r.shape[4]].float()
                                 - 0.5, r.float() - 0.5, dt)
        ok &= o
        if worst is None or not o or st["cos"] < worst["cos"]:
            worst = st
    same_rows = [r["FileSetId"] for r in rows_b] == [
        r["FileSetId"] for r in rows_u]
    seconds = [run(BUCKET)[0] for _ in range(2)]
    steps = 2 * -(-(n_images // 2) // eval_batch)   # two true shapes
    counted = (launches["fused_conv_dyn"] > 0
               and launches["max_pool3d_cl"] > 0
               and launches["banded_conv_dyn"] == steps * MEMBERS * 2
               and launches["fused_conv"] == launches["banded_conv"] == 0)
    return ok and same_rows and counted, {
        "phase": "zoo_serving", "model": "FPN", "dtype": str(dt),
        "images": n_images, "eval_batch": eval_batch, "bucket": BUCKET,
        "ok": ok and same_rows, "launches": launches,
        "launches_match": counted, "worst_dispatch": worst,
        "img_per_s_kernels": n_images / min(seconds),
        "seconds_kernels_runs": seconds,
        "rows": [[r["FileSetId"], r["Dice"], r["Hausdorff"]]
                 for r in rows_b], "card": card}


def zoo_train(cfg, tag, dt, B, sd, card):
    """Phase 9 (a): one FPN train step on the kernel path against
    ``kernels=False`` and the higher-precision plain step, checked as in
    phase 5 (the loss, the running stats, SGD's step, ``compare_grads``),
    with the train kernels' launches.  (ok, record)."""
    import torch
    from multimodal_fusion_fpn_torch import ops
    ref_dtype = {torch.bfloat16: torch.float32,
                 torch.float32: torch.float64}[dt]
    tr = Trainer(cfg, dt, "cuda")
    batch = make_batch(B, 4)
    del batch["slo"]
    results = {}
    for kern in (False, True):
        tr.reset(sd)
        torch.cuda.synchronize()
        ops.reset_launches()
        aux = tr.step(batch, kernels=kern)
        torch.cuda.synchronize()
        if kern:
            launches = ops.kernel_launches()
        results[kern] = (aux, *tr.snapshot())
    ref_tr = Trainer(cfg, ref_dtype, "cuda")
    ref_tr.reset(sd)
    ref_tr.step(batch, kernels=False)
    ref_grads = ref_tr.snapshot()[0]
    del ref_tr, tr
    ok_f, cmp = compare_forward(results[True], results[False], dt)
    ok_g, cmp_g = compare_grads(results[True][1], results[False][1],
                                ref_grads, dt)
    ok_u = True
    for kern, label in ((True, "kernels"), (False, "plain")):
        o, cmp[f"sgd_update_worst_rel_err_{label}"] = check_sgd_update(
            sd, {k: v.cpu() for k, v in results[kern][1].items()},
            {k: v.cpu() for k, v in results[kern][2].items()})
        ok_u &= o
    counted = (all(launches[k] > 0 for k in TRAIN_KERNELS
                   if not k.startswith("banded"))
               and launches["banded_conv"] == 2
               and launches["banded_conv_wgrad"] == 2
               and launches["banded_conv_dgrad"] == 0)
    cmp.update(cmp_g, reference_dtype=str(ref_dtype))
    ok = ok_f and ok_g and ok_u
    return ok and counted, {
        "phase": "zoo_train", "model": cfg.model, "config": tag, "batch": B,
        "ok": ok, "forward_ok": ok_f, "grads_ok": ok_g, "sgd_ok": ok_u,
        "launches": launches, "launches_grew": counted, "card": card, **cmp}


def zoo_phase(configs, card):
    """Phase 9, the rest of the zoo (module note): the failures."""
    import torch
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    t0 = time.time()
    failures = []

    def check(ok, rec, what):
        emit(rec)
        if not ok:
            failures.append(f"zoo: {what}")

    # (a) FPN, the model run.sh trains and serves
    cfg = zoo_cfg("FPN")
    models = {tag: build_model(cfg, dtype=dt) for tag, dt, _ in configs}
    sds = member_state_dicts(models["fp32_B1"], MEMBERS)
    for tag, dt, B in configs:
        check(*zoo_eval("FPN", tag, dt, B, models[tag], sds, card,
                        timed=True), f"FPN ensemble {tag}")
    ok, st = zoo_small_vs_cpu("FPN", sds[1])
    check(ok, {"phase": "zoo_small_vs_cpu", "model": "FPN", "ok": ok, **st},
          "FPN small input vs CPU")
    for tag, dt, B in configs:
        ok, rec = zoo_serving(
            make_ensemble_eval_step(models[tag], sds, with_hd=True), dt,
            SERVE_IMAGES if dt == torch.bfloat16 else ZOO_FP32_SERVE_IMAGES,
            B, card)
        check(ok, dict(rec, config=tag), f"FPN serving {tag}")
    del models
    torch.cuda.empty_cache()
    for tag, dt, B in configs:
        check(*zoo_train(cfg, tag, dt, B, sds[0], card), f"FPN train {tag}")
    torch.cuda.empty_cache()
    # (b) one member of FPN2D, FPNLateFusion ('2d_max') and
    # FPNClassification
    for name in ("FPN2D", "FPNLateFusion", "FPNClassification"):
        models = {tag: build_model(zoo_cfg(name), dtype=dt)
                  for tag, dt, _ in configs}
        sd = member_state_dicts(models["fp32_B1"], 1)
        for tag, dt, B in configs:
            check(*zoo_eval(name, tag, dt, B, models[tag], sd, card),
                  f"{name} eval {tag}")
            if name != "FPNClassification":
                check(*zoo_bucketed(name, tag, dt, B, models[tag], sd[0]),
                      f"{name} bucketed {tag}")
        ok, st = zoo_small_vs_cpu(name, sd[0])
        check(ok, {"phase": "zoo_small_vs_cpu", "model": name, "ok": ok,
                   **st}, f"{name} small input vs CPU")
        del models
        torch.cuda.empty_cache()
    # (c) each Regression variant is its base model before the sigmoid
    batch = zoo_batch("FPNHybridFusion", 4, 3)
    for reg, base in ZOO_REGRESSION:
        outs = {}
        for name in (reg, base):
            model = build_model(zoo_cfg(name), dtype=torch.bfloat16)
            if name == reg:
                sd = member_state_dicts(model, 1)[0]
            model.load_state_dict(sd)
            with torch.inference_mode():
                outs[name] = model(batch)["prediction"]
        same = bool(torch.equal(torch.sigmoid(outs[reg]), outs[base]))
        check(same, {"phase": "zoo_regression", "model": reg, "base": base,
                     "config": "bf16_B4", "ok": same}, f"{reg} vs {base}")
    emit({"phase": "zoo_done", "ok": not failures,
          "seconds": time.time() - t0, "card": card})
    return failures



def entry_argv(paths, precision):
    """The entry point's argv for a synthetic tree: ``tests/test_e2e.py``'s
    model and crop at the ini widths (no ``--arch-config``)."""
    return ["--training-dataset", "hrf_fusion", "--model", "FPNHybridFusion",
            "--crop", "relative_2d_max", "--fusion-modality", "slo",
            "--version", "chip_smoke", "--data-root", paths["oct"],
            "--split-name", "split", "--precision", precision,
            "--eval-batch", str(ENTRY_BATCH), "--save-all-outputs"]


def entry_members(paths, ckpt_dir, fault=False):
    """Five seeded members (``member_state_dicts``), each with its final
    bias moved by minus the median logit of its fp32 prediction on the
    tree's first visit (so that the thresholded artifacts are not empty),
    written to ``ckpt_dir`` as ``epoch=*.ckpt``; with ``fault`` the first
    member's ENTRY_FAULT conv is zeroed."""
    import os
    import torch
    from multimodal_fusion_fpn_torch.config import parse_config
    from multimodal_fusion_fpn_torch.eval.configs import opt_factory
    from multimodal_fusion_fpn_torch.eval.harness import \
        create_val_dataloader
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    from multimodal_fusion_fpn_torch.train.checkpoints import save_checkpoint
    cfg = parse_config(entry_argv(paths, "fp32"))
    opt = opt_factory["hrf_fusion"](cfg)
    with open(paths["split"]) as f:
        ids = json.load(f)["test"]
    batch = next(iter(create_val_dataloader(opt, ids,
                                            opt.get_val_transforms(), 0)))
    b = {k: torch.as_tensor(batch[k], device="cuda")
         for k in ("image", "slo")}
    model = build_model(cfg)
    os.makedirs(ckpt_dir, exist_ok=True)
    for i, sd in enumerate(member_state_dicts(model, MEMBERS)):
        model.load_state_dict(sd)
        with torch.inference_mode():
            p = model(b, kernels=False)["prediction"].double()
        sd["resensnet.final1.bias"] -= float(
            torch.logit(p.clamp(1e-12, 1 - 1e-12)).median())
        if fault and i == 0:
            sd[ENTRY_FAULT].zero_()
        save_checkpoint(os.path.join(ckpt_dir, f"epoch={i}-Dice=0.5.ckpt"),
                        sd)


def entry_run(paths, precision, workdir, ckpt_dir, device="cuda",
              kernels=True, profile=False):
    """One run of the entry point in its own working directory, its
    members linked from ``ckpt_dir``: (the run's info, its files, the
    launch counts, the profiler's busy ms or None)."""
    import os
    import torch
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch import paths as path_utils
    from multimodal_fusion_fpn_torch import validate_ensemble
    from multimodal_fusion_fpn_torch.config import parse_config
    argv = entry_argv(paths, precision)
    model_path = os.path.join(workdir, path_utils.get_model_path(
        parse_config(argv), os.path.join(paths["oct"], "split")))
    os.makedirs(model_path)
    for name in sorted(os.listdir(ckpt_dir)):
        os.symlink(os.path.join(ckpt_dir, name),
                   os.path.join(model_path, name))
    prev = os.getcwd()
    os.chdir(workdir)
    try:
        # the entry point's log (its config, one line per image) stays out
        with contextlib.redirect_stdout(io.StringIO()):
            ops.reset_launches()
            if profile:
                box = []
                busy, _ = trace_step(lambda: box.append(
                    validate_ensemble.run(argv, device=device,
                                          kernels=kernels)))
                info = box[0]
            else:
                busy = None
                info = validate_ensemble.run(argv, device=device,
                                             kernels=kernels)
            if device == "cuda":
                torch.cuda.synchronize()
            launches = ops.kernel_launches()
            try:   # a second run finds the results and skips
                validate_ensemble.run(argv, device=device, kernels=kernels)
                info["skipped"] = False
            except SystemExit as exc:
                info["skipped"] = exc.code == 0
    finally:
        os.chdir(prev)
    out = os.path.join(workdir, info["output_path"])
    files = {}
    for d, _, names in os.walk(out):
        for n in names:
            files[os.path.relpath(os.path.join(d, n), out)] = \
                os.path.join(d, n)
    return info, files, launches, busy


def entry_rows(path):
    """The numeric columns of a test_output.csv: {name: float64 array}."""
    import csv
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    out = {}
    for j, name in enumerate(rows[0][1:], 1):
        try:
            out[name] = np.array([float(r[j]) if r[j] else np.nan
                                  for r in rows[1:]])
        except ValueError:
            continue
    return out


def entry_compare(a, b, dtype):
    """compare() of two runs' all_outputs.npz predictions, and for fp32
    their metric rows at rel 1e-4 (NaN where NaN)."""
    import torch
    pa = np.load(a["all_outputs.npz"])
    pb = np.load(b["all_outputs.npz"])
    ok, st = compare(torch.from_numpy(pa["pred"]),
                     torch.from_numpy(pb["pred"]), dtype)
    ok &= bool(np.array_equal(pa["gt"], pb["gt"]))
    st["above_half"] = float((pb["pred"] > 0.5).mean())
    if dtype == torch.float32:
        ra, rb = entry_rows(a["test_output.csv"]), entry_rows(
            b["test_output.csv"])
        worst = 0.0
        for k in rb:
            x, y = ra[k], rb[k]
            same_nan = np.array_equal(np.isnan(x), np.isnan(y))
            m = ~np.isnan(y)
            err = np.abs(x[m] - y[m]) / np.maximum(np.abs(y[m]), 1e-30)
            worst = max(worst, float(err.max(initial=0.0)))
            ok &= same_nan
        st["rows_max_rel"] = worst
        ok &= worst <= 1e-4
    return ok, st


def entry_phase(card):
    """Phase 10, the serving entry point (module note): the failures and
    the launch counts of the bf16 kernel run."""
    import os
    import tempfile
    import torch
    from multimodal_fusion_fpn_torch.data.synthetic import \
        make_synthetic_hrf
    t0 = time.time()
    failures = []

    def check(ok, rec, what):
        emit(dict(rec, ok=bool(ok)))
        if not ok:
            failures.append(f"entry point: {what}")

    with tempfile.TemporaryDirectory() as tmp:
        j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
        big = make_synthetic_hrf(j("big"), n_patients=1,
                                 visits_per_patient=ENTRY_VISITS,
                                 d=ENTRY_OCT[0], h=ENTRY_OCT[1],
                                 w=ENTRY_OCT[2], enface_h=ENTRY_SLO[0],
                                 enface_w=ENTRY_SLO[1], seed=21)
        small = make_synthetic_hrf(j("small"), n_patients=1,
                                   visits_per_patient=ENTRY_SMALL_VISITS,
                                   d=ENTRY_SMALL_OCT[0],
                                   h=ENTRY_SMALL_OCT[1],
                                   w=ENTRY_SMALL_OCT[2],
                                   enface_h=ENTRY_SMALL_SLO[0],
                                   enface_w=ENTRY_SMALL_SLO[1], seed=22)
        entry_members(big, j("ckpt"))
        entry_members(big, j("ckpt_fault"), fault=True)
        emit({"phase": "entry_setup", "seconds": time.time() - t0})

        # bf16: kernels (launches), plain, kernels timed, kernels profiled
        runs = {}
        for name, kern, prof in (("kernels", True, False),
                                 ("plain", False, False),
                                 ("kernels_timed", True, False),
                                 ("kernels_profiled", True, True)):
            runs[name] = entry_run(big, "bf16", j(name), j("ckpt"),
                                   kernels=kern, profile=prof)
        info, files, launches, _ = runs["kernels"]
        launches = {k: launches.get(k, 0) for k in KERNELS}
        want = {k: ENTRY_LAUNCHES.get(k, 0) for k in KERNELS}
        check(launches == want, {"phase": "entry_launches",
                                 "launches": launches, "expected": want},
              f"launches {launches} != {want}")
        same_tree = all(sorted(r[1]) == sorted(files)
                        for r in runs.values())
        n_img = ENTRY_VISITS
        per_image = [f for f in files if f.endswith("/info.json")]
        with open(files["global_metrics.json"]) as f:
            gm = json.load(f)
        check(same_tree and len(per_image) == n_img and gm == {}
              and all(r[0]["skipped"] for r in runs.values()),
              {"phase": "entry_tree", "files": len(files),
               "images": len(per_image), "global_metrics": gm,
               "skipped": [r[0]["skipped"] for r in runs.values()]},
              "the bf16 runs' result trees differ, or do not skip")
        ok, st = entry_compare(files, runs["plain"][1], torch.bfloat16)
        check(ok, {"phase": "entry_bf16_vs_plain", **st},
              "bf16 predictions, kernels vs plain")
        for name in ("kernels_timed", "plain"):
            info = runs[name][0]
            tm = info["timing"]
            emit({"phase": "entry_rate", "run": name, "images": n_img,
                  "eval_batch": ENTRY_BATCH,
                  "img_per_s_entry": n_img / info["seconds"],
                  "img_per_s_evaluate": n_img / (info["evaluate"]
                                                 - tm["load"]),
                  "seconds_entry": info["seconds"],
                  "seconds_evaluate": info["evaluate"],
                  "seconds_split": tm,
                  "seconds_outside_evaluate": info["seconds"]
                  - info["evaluate"], "card": card})
        info, _, _, busy = runs["kernels_profiled"]
        timed = runs["kernels_timed"][0]
        emit({"phase": "entry_busy", "device_busy_ms": busy,
              "seconds_profiled_run": info["seconds"],
              "busy_share_of_profiled_run": busy / 1e3 / info["seconds"],
              "busy_share_of_timed_run": busy / 1e3 / timed["seconds"],
              "busy_share_of_timed_evaluate": busy / 1e3 / (
                  timed["evaluate"] - timed["timing"]["load"]),
              "card": card})

        # fp32 on two small visits: the card against the CPU, and the
        # planted fault against the card
        entry_members(small, j("ckpt_small"))
        entry_members(small, j("ckpt_small_fault"), fault=True)
        card_run = entry_run(small, "fp32", j("fp32_card"), j("ckpt_small"))
        cpu_run = entry_run(small, "fp32", j("fp32_cpu"), j("ckpt_small"),
                            device="cpu")
        fault_run = entry_run(small, "fp32", j("fp32_fault"),
                              j("ckpt_small_fault"))
        ok, st = entry_compare(card_run[1], cpu_run[1], torch.float32)
        check(ok and sorted(card_run[1]) == sorted(cpu_run[1])
              and card_run[0]["skipped"] and cpu_run[0]["skipped"],
              {"phase": "entry_fp32_card_vs_cpu",
               "images": ENTRY_SMALL_VISITS, **st},
              "fp32 card vs CPU")
        agree, st = entry_compare(fault_run[1], card_run[1], torch.float32)
        check(not agree, {"phase": "entry_planted_fault",
                          "conv": ENTRY_FAULT, "caught": not agree, **st},
              "the planted fault (a zeroed conv) was not caught")
    emit({"phase": "entry_done", "ok": not failures,
          "seconds": time.time() - t0, "card": card})
    return failures, launches


def per_step(records, field):
    return sum(r[field] * r["calls_per_step"] for r in records)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    from multimodal_fusion_fpn_torch.ops import _build, fused_block

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    t_start = time.time()

    # --- 1. build ---------------------------------------------------------
    libs = ["fused_conv", "fused_conv_mma", "fused_conv_bwd",
            "fused_conv_bwd_mma", "pool", "fused_block", "fused_block_mma",
            "banded_conv"]
    _build.build(libs)
    for name in libs:
        _build.load(name)
    card = card_line()
    print(card, flush=True)
    hmma = {lib: hmma_counts(_build.library_path(lib))
            for lib in ("fused_conv_mma", "fused_conv_bwd_mma",
                        "fused_block_mma")}
    emit({"phase": "build", "seconds": time.time() - t_start,
          "libraries": [_build.library_path(n) for n in libs],
          "hmma_per_bf16_forward_kernel": hmma["fused_conv_mma"],
          "hmma_per_bf16_backward_kernel": hmma["fused_conv_bwd_mma"],
          "hmma_per_bf16_block_kernel": hmma["fused_block_mma"],
          "bf16_block_kernel_instances": len(hmma["fused_block_mma"])})
    for lib, n_inst in (("fused_conv_mma", FWD_MMA_INSTANCES),
                        ("fused_conv_bwd_mma", None),
                        ("fused_block_mma", K8_MMA_INSTANCES)):
        no_tc = [k for k, n in hmma[lib].items() if n == 0]
        if not hmma[lib] or no_tc or n_inst not in (None, len(hmma[lib])):
            failures.append(f"{lib}: tensor-core kernels without HMMA, or "
                            f"not {n_inst} of them: {no_tc or hmma[lib]}")

    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)

    configs = [("bf16_B4", torch.bfloat16, 4), ("fp32_B1", torch.float32, 1)]
    models = {tag: build_model(cfg, dtype=dt) for tag, dt, _ in configs}
    sds = member_state_dicts(models["fp32_B1"], MEMBERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}   # (tag, key) -> record, every kernel check

    # --- 2. eval kernels vs plain at every eval call shape ---------------
    shapes = {}
    for tag, dt, B in configs:
        model = models[tag]
        model.load_state_dict(sds[0])
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in make_batch(B, 0).items()}
        ops.reset_launches()
        with torch.inference_mode():
            model(batch)
        torch.cuda.synchronize()
        shapes[tag] = recorded_calls()
        n_k10 = shapes[tag]["launches"]["banded_conv"]
        emit({"phase": "shapes", "config": tag,
              "launches_per_member": shapes[tag]["launches"]})
        if n_k10 != K10_PER_MEMBER:
            failures.append(f"shapes {tag}: {n_k10}"
                            f" K10 launches per member, not "
                            f"{K10_PER_MEMBER}")
    for tag, _, _ in configs:
        conv_calls, pool_calls = (shapes[tag]["fused_conv"],
                                  shapes[tag]["pool"])
        for key, n in sorted(conv_calls.items(), key=str):
            records[(tag, key)] = check_conv_shape(key, MEMBERS * n, gen)
            emit(records[(tag, key)])
        largest = max(pool_calls, key=lambda k: int(np.prod(k[1])))
        for key, n in sorted(pool_calls.items(), key=str):
            records[(tag, key)] = check_pool_shape(
                key, MEMBERS * n, gen, nan_control=key == largest)
            emit(records[(tag, key)])
    emit({"phase": "pool_host_path", "us_per_call": pool_host_path(),
          "card": card})

    # --- 3. ensemble, end to end -----------------------------------------
    main_launches = {}
    for tag, dt, B in configs:
        model = models[tag]
        step = make_ensemble_eval_step(model, sds)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in make_batch(B, 1).items() if k != "mask"}
        step(batch, kernels=False)
        step(batch)
        torch.cuda.synchronize()
        ops.reset_launches()
        pred = step(batch)["prediction"]
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
        ref = step(batch, kernels=False)["prediction"]
        torch.cuda.synchronize()
        if tag == "bf16_B4":
            main_launches["ensemble"] = launches
        ok, stats = compare(pred.float() - 0.5, ref.float() - 0.5, dt)
        if pred.shape != (B, 1, OCT_YZX[0], 1, OCT_YZX[2]):
            ok = False
        per_member = shapes[tag]["launches"]
        counted = all(launches[k] == MEMBERS * per_member[k] > 0
                      for k, v in KERNELS.items() if v[2] == "ensemble")
        times, busy = timed_paths(
            lambda kernels: step(batch, kernels=kernels))
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        emit({"phase": "e2e", "config": tag, "members": MEMBERS, "batch": B,
              "prediction_shape": list(pred.shape), "ok": ok,
              "launches": launches, "launches_match": counted,
              **timing_record(times, busy, B),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "card": card, **stats})
        if not ok:
            failures.append(f"e2e {tag}: kernel path disagrees with plain")
        if not counted:
            failures.append(f"e2e {tag}: launches {launches} != "
                            f"{MEMBERS} x {per_member}")

    # one member on a small input against the CPU's plain path
    small = make_batch(1, 2, (8, 64, 32), (80, 32))
    model = models["fp32_B1"]
    model.load_state_dict(sds[1])
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v).cuda()
                     for k, v in small.items()})["prediction"].cpu()
        cpu_model = build_model(cfg, device="cpu")
        cpu_model.load_state_dict(sds[1])
        want = cpu_model({k: torch.from_numpy(v)
                          for k, v in small.items()})["prediction"]
    ok, stats = compare(got, want, torch.float32)
    emit({"phase": "small_vs_cpu", "ok": ok, **stats})
    if not ok:
        failures.append("small input: card disagrees with the CPU")
    del models
    torch.cuda.empty_cache()

    # --- 4. train kernels vs plain at every train-step call shape -------
    trainers = {tag: Trainer(cfg, dt, "cuda") for tag, dt, _ in configs}
    train_shapes = {}
    for tag, dt, B in configs:
        tr = trainers[tag]
        tr.reset(sds[0])
        batch = make_batch(B, 3)
        ops.reset_launches()
        tr.step(batch)
        torch.cuda.synchronize()
        train_shapes[tag] = recorded_calls()
        emit({"phase": "train_shapes", "config": tag,
              "launches_per_step": train_shapes[tag]["launches"]})
    check = {"fused_conv_stats": check_stats_shape,
             "fused_conv_ky3_stats": check_stats_shape,
             "fused_conv_dgrad": check_bwd_shape,
             "fused_conv_wgrad": check_bwd_shape,
             "fused_conv_ky3_dgrad": check_bwd_shape,
             "fused_conv_ky3_wgrad": check_bwd_shape,
             "max_pool3d_cl_bwd": check_pool_bwd_shape}
    for tag, _, _ in configs:
        conv_calls = train_shapes[tag]["fused_conv"]
        pool_calls = train_shapes[tag]["pool"]
        for key, n in sorted({**conv_calls, **pool_calls}.items(), key=str):
            if key[0] in check:
                rec = check[key[0]](key, n, gen)
                records[(tag, key)] = rec
                emit(rec)
    bad = [r for r in records.values() if not r["ok"]]
    if bad:
        failures.append(f"{len(bad)} kernel/plain comparisons failed: "
                        f"{sorted({r['kernel'] for r in bad})}")

    # --- 5. train, end to end ---------------------------------------------
    ref_dtype = {torch.bfloat16: torch.float32, torch.float32: torch.float64}
    for tag, dt, B in configs:
        tr = trainers[tag]
        batch = make_batch(B, 4)
        results, plain_trace, ref_trace = {}, {}, {}
        for kern in (False, True):
            tr.reset(sds[0])
            torch.cuda.synchronize()
            if kern:
                ops.reset_launches()
                aux = tr.step(batch, kernels=True)
                torch.cuda.synchronize()
                launches = ops.kernel_launches()
            else:
                with cotangent_trace(tr.model, plain_trace):
                    aux = tr.step(batch, kernels=False)
            results[kern] = (aux, *tr.snapshot())
        ref_tr = Trainer(cfg, ref_dtype[dt], "cuda")
        ref_tr.reset(sds[0])
        with cotangent_trace(ref_tr.model, ref_trace):
            ref_tr.step(batch, kernels=False)
        ref_grads = ref_tr.snapshot()[0]
        del ref_tr
        torch.cuda.empty_cache()
        if tag == "bf16_B4":
            main_launches["train"] = launches
        ok_f, cmp = compare_forward(results[True], results[False], dt)
        ok_g, cmp_g = compare_grads(results[True][1], results[False][1],
                                    ref_grads, dt)
        ok_u = True
        for kern, label in ((True, "kernels"), (False, "plain")):
            o, cmp[f"sgd_update_worst_rel_err_{label}"] = check_sgd_update(
                sds[0], {k: v.cpu() for k, v in results[kern][1].items()},
                {k: v.cpu() for k, v in results[kern][2].items()})
            ok_u &= o
        # each fused block from the same input and cotangent, then the
        # planted faults, each of which the block check must report
        tr.reset(sds[0])
        cap = capture_blocks(tr, batch)
        ok_b, blocks = check_blocks(tr, cap, dt)
        controls = {}
        for fault in CONTROLS:
            with planted(fault):
                c_blocks = check_blocks(tr, cap, dt)[0]
                tr.reset(sds[0])
                tr.step(batch)
                c_grads = compare_grads(tr.snapshot()[0], results[False][1],
                                        ref_grads, dt)[0]
            controls[fault] = {"blocks_ok": c_blocks, "grads_ok": c_grads}
        caught = not any(c["blocks_ok"] for c in controls.values())
        del cap
        torch.cuda.empty_cache()
        ok = ok_f and ok_g and ok_u and ok_b and caught
        cmp.update(cmp_g, reference_dtype=str(ref_dtype[dt]))
        counted = all(launches[k] > 0 for k in TRAIN_KERNELS + [
            "max_pool3d_cl"]) and all(launches[k] == n for k, n in
                                      K10_PER_TRAIN_STEP.items())
        emit({"phase": "train_blocks", "config": tag, "ok": ok_b,
              "blocks": blocks})
        emit({"phase": "grad_trace", "config": tag,
              "reference_dtype": str(ref_dtype[dt]),
              "modules": [[n, grad_agreement(plain_trace[n], g)[0],
                           g.norm().item()]
                          for n, g in ref_trace.items() if n in plain_trace]})
        del plain_trace, ref_trace
        times, busy = timed_paths(lambda kernels: tr.step(batch, kernels))
        torch.cuda.reset_peak_memory_stats()
        tr.step(batch)
        torch.cuda.synchronize()
        emit({"phase": "train_e2e", "config": tag, "batch": B, "ok": ok,
              "forward_ok": ok_f, "grads_ok": ok_g, "sgd_ok": ok_u,
              "blocks_ok": ok_b, "controls": controls,
              "controls_caught": caught,
              "launches": launches, "launches_grew": counted, **cmp,
              **timing_record(times, busy, B),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "card": card})
        if not ok:
            failures.append(f"train {tag}: forward {ok_f}, gradients {ok_g},"
                            f" SGD {ok_u}, blocks {ok_b}, controls caught "
                            f"{caught}")
        if not counted:
            failures.append(f"train {tag}: a train kernel was not "
                            f"launched, or K10's launches are not "
                            f"{K10_PER_TRAIN_STEP}: {launches}")

    # one fp32 train step on a small input against the CPU
    small = make_batch(1, 5, (8, 64, 32), (80, 32))
    tr = trainers["fp32_B1"]
    tr.reset(sds[1])
    aux = tr.step(small)
    on_card = (aux, *tr.snapshot())
    cpu = Trainer(cfg, torch.float32, "cpu")
    cpu.reset(sds[1])
    aux = cpu.step(small)
    ok, cmp = compare_whole(
        ({k: v.cpu() if torch.is_tensor(v) else v
          for k, v in on_card[0].items()},
         *({k: v.cpu() for k, v in d.items()} for d in on_card[1:])),
        (aux, *cpu.snapshot()))
    emit({"phase": "train_small_vs_cpu", "ok": ok, **cmp})
    if not ok:
        failures.append("train, small input: card disagrees with the CPU")

    del trainers, tr, cpu
    torch.cuda.empty_cache()

    # --- 6. bucketed serving ----------------------------------------------
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step as ensemble_step
    from multimodal_fusion_fpn_torch.eval.harness import bucket_pad
    models = {tag: build_model(cfg, dtype=dt) for tag, dt, _ in configs}
    bucketed_shapes = {}
    for tag, dt, B in configs:
        model = models[tag]
        model.load_state_dict(sds[0])
        b = serving_batch(B, 7)
        padded = bucket_pad({k: b[k] for k in ("image", "slo")}, BUCKET)
        ops.reset_launches()
        with torch.inference_mode():
            model({k: torch.as_tensor(v, device="cuda")
                   if not k.startswith("__") else v
                   for k, v in padded.items()})
        torch.cuda.synchronize()
        bucketed_shapes[tag] = recorded_calls()
        emit({"phase": "bucketed_shapes", "config": tag,
              "padded_image": list(padded["image"].shape),
              "padded_slo": list(padded["slo"].shape),
              "launches_per_member": bucketed_shapes[tag]["launches"]})
    n_bad = len(failures)
    for tag, _, _ in configs:
        conv_calls = bucketed_shapes[tag]["fused_conv"]
        pool_calls = bucketed_shapes[tag]["pool"]
        for key, n in sorted(conv_calls.items(), key=str):
            rec = check_dyn_shape(key, MEMBERS * n, gen)
            records[("bucketed_" + tag, key)] = rec
            emit(rec)
        for key, n in sorted(pool_calls.items(), key=str):
            rec = check_pool_shape(key, MEMBERS * n, gen)
            records[("bucketed_" + tag, key)] = rec
            emit(rec)
        if not conv_calls or any(k[0] not in ("fused_conv_dyn",
                                              "fused_conv_dyn_ky3")
                                 for k in conv_calls):
            failures.append(f"bucketed {tag}: fused convs {sorted(conv_calls)}"
                            " are not all extents instances")
        k10 = bucketed_shapes[tag]["banded_conv"]
        if (sum(k10.values()) != K10_PER_MEMBER
                or any(k[0] != "banded_conv_dyn" for k in k10)):
            failures.append(f"bucketed {tag}: K10 calls {k10} are not "
                            f"{K10_PER_MEMBER} extents instances")
    bad = [r for (tag, _), r in records.items()
           if tag.startswith("bucketed_") and not r["ok"]]
    if bad:
        failures.append(f"{len(bad)} bucketed kernel/plain comparisons "
                        f"failed: {sorted({r['kernel'] for r in bad})}")
    for tag, dt, B in configs:
        ok, rec = check_bucketed_ensemble(tag, dt, B, models[tag], sds)
        emit(dict(rec, card=card))
        if not ok:
            failures.append(
                f"bucketed {tag}: vs unpadded {rec['vs_unpadded']['ok']}, "
                f"plain vs unpadded {rec['plain_vs_plain_unpadded']['ok']}, "
                f"vs plain {rec['vs_plain']['ok']}, control caught "
                f"{rec['control_caught']}, Hausdorff {rec['hausdorff_ok']}")
    rec, main_launches["bucketed"] = serving_rate(
        ensemble_step(models["bf16_B4"], sds, with_hd=True), card)
    emit(rec)
    if not all(main_launches["bucketed"][k] > 0
               for k, v in KERNELS.items() if v[2] == "bucketed"):
        failures.append(f"serving: K7 or K10 was not launched: "
                        f"{main_launches['bucketed']}")
    serve_steps = SERVE_IMAGES // SERVE_BATCH
    if (main_launches["bucketed"]["banded_conv_dyn"]
            != serve_steps * MEMBERS * K10_PER_MEMBER):
        failures.append(f"serving: K10 launches "
                        f"{main_launches['bucketed']['banded_conv_dyn']} != "
                        f"{serve_steps} steps x {MEMBERS} x "
                        f"{K10_PER_MEMBER}")
    emit({"phase": "bucketed_done", "ok": len(failures) == n_bad,
          "seconds": time.time() - t_start})
    del models
    torch.cuda.empty_cache()

    # --- 7. eval block fusion (K8) ----------------------------------------
    n_bad = len(failures)
    models = {tag: build_model(cfg, dtype=dt) for tag, dt, _ in configs}
    for tag, dt, B in configs:
        model = models[tag]
        model.load_state_dict(sds[0])
        crop = {k: torch.from_numpy(v).cuda()
                for k, v in make_batch(B, 0).items()}
        b = serving_batch(B, 7)
        padded = {k: torch.as_tensor(v, device="cuda")
                  if not k.startswith("__") else v
                  for k, v in bucket_pad({k: b[k] for k in ("image", "slo")},
                                         BUCKET).items()}
        k8_calls = {}
        for inputs in (crop, padded):
            for mode in K8_MODES:
                ops.reset_launches()
                with torch.inference_mode():
                    model(inputs, block_fusion=mode)
                torch.cuda.synchronize()
                k8_calls.update(fused_block.calls)
        emit({"phase": "k8_shapes", "config": tag,
              "calls_per_member": [[list(map(str, k)), n]
                                   for k, n in sorted(k8_calls.items(),
                                                      key=str)]})
        for key, n in sorted(k8_calls.items(), key=str):
            rec = check_block_shape(key, MEMBERS * n, gen)
            records[("k8_" + tag, key)] = rec
            emit(rec)
    bad = [r for (tag, _), r in records.items()
           if tag.startswith("k8_") and not r["ok"]]
    if bad:
        failures.append(f"{len(bad)} chain/pair kernel checks failed: "
                        f"{sorted({r['kernel'] for r in bad})}")
    for tag, dt, B in configs:
        ok, rec, launches = k8_ensemble(tag, dt, B, models[tag], sds, card)
        emit(rec)
        if tag == "bf16_B4":
            main_launches.update(launches)
        if not ok:
            failures.append(f"k8 ensemble {tag}: "
                            + ", ".join(f"{m} {rec[m]['ok']}"
                                        for m in K8_MODES))
        ok, rec = k8_bucketed(tag, dt, B, models[tag], sds)
        emit(rec)
        if not ok:
            failures.append(f"k8 bucketed {tag}: {rec}")
    rec, launches = k8_serving(ensemble_step(models["bf16_B4"], sds,
                                             with_hd=True), card)
    emit(rec)
    main_launches["bucketed_chain"] = launches["chain"]
    main_launches["bucketed_pair"] = launches["pair"]
    emit({"phase": "k8_done", "ok": len(failures) == n_bad,
          "seconds": time.time() - t_start})
    del models
    torch.cuda.empty_cache()

    # --- 8. the narrow-entry conv (K10) -----------------------------------
    n_bad = len(failures)
    k10 = k10_checks(shapes, train_shapes, bucketed_shapes)
    emit({"phase": "k10_shapes",
          "calls_per_step": [[tag, list(map(str, key)), n]
                             for (tag, key), n in sorted(k10.items(),
                                                         key=str)]})
    for (tag, key), n in sorted(k10.items(), key=str):
        rec = check_banded_shape(key, n, gen)
        records[(tag, key)] = rec
        emit(dict(rec, config=tag, card=card))
    bad = [r for (tag, key), r in records.items()
           if (tag, key) in k10 and not r["ok"]]
    if bad:
        failures.append(f"{len(bad)} K10 kernel checks failed: "
                        f"{sorted({r['kernel'] for r in bad})}")
    emit({"phase": "k10_done", "ok": len(failures) == n_bad,
          "seconds": time.time() - t_start})

    # --- 9. the rest of the zoo ------------------------------------------
    failures += zoo_phase(configs, card)

    # --- 10. the serving entry point --------------------------------------
    entry_failures, main_launches["entry"] = entry_phase(card)
    failures += entry_failures

    # --- 11. summary ------------------------------------------------------
    summary = []
    for name, (source, replaces, path) in KERNELS.items():
        prefix = RECORD_PREFIX.get(path, "")
        main = [r for (tag, _), r in records.items()
                if tag == prefix + "bf16_B4" and r["kernel"] == name]
        fp32 = [r for (tag, _), r in records.items()
                if tag == prefix + "fp32_B1" and r["kernel"] == name]
        t_bytes = sum(r["calls_per_step"] * r["bound_ms"]
                      for r in main if r["bound_by"] == "bytes")
        t_ops = sum(r["calls_per_step"] * r["bound_ms"]
                    for r in main if r["bound_by"] != "bytes")
        launches = main_launches[path][name]
        lib = [r["library_ms"] for r in main]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "step": path, "launches": launches,
            "launches_train_step": main_launches["train"][name],
            "launches_ensemble_step": main_launches["ensemble"][name],
            "launches_bucketed_serving": main_launches["bucketed"][name],
            "launches_entry_point": main_launches["entry"][name],
            "max_abs_err": max(r["max_err"] for r in fp32),
            "ms": per_step(main, "kernel_ms"),
            "plain_ms": per_step(main, "plain_ms"),
            "bound_ms": per_step(main, "bound_ms"),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_cuda_cores_ms": sum(
                r["calls_per_step"] * r.get("bound_cuda_cores_ms",
                                            r["bound_ms"]) for r in main),
            "library_ms": (None if None in lib
                           else per_step(main, "library_ms"))})
        if main and "per_conv_ms" in main[0]:
            summary[-1].update(
                instances=K8_INSTANCES,
                cuda_cores_ms=per_step(main, "cuda_cores_ms"),
                per_conv_ms=per_step(main, "per_conv_ms"),
                per_conv_cuda_cores_ms=per_step(main,
                                                "per_conv_cuda_cores_ms"))
        if main and "max_pool3d_ms" in main[0]:
            summary[-1].update(library="amax",
                               max_pool3d_ms=per_step(main, "max_pool3d_ms"))
        if main and "generic_ms" in main[0]:
            summary[-1]["generic_ms"] = per_step(main, "generic_ms")
        if name in TC_ROWS:
            summary[-1].update(
                tpu_rows=TC_ROWS[name],
                instances=(BWD_INSTANCES if name.endswith("grad")
                           else FWD_INSTANCES),
                cuda_cores_ms=per_step(main, "cuda_cores_ms"))
        if name in OFF_PATH:
            summary[-1]["on_main_path"] = False
            if launches != 0:
                failures.append(f"{name} was launched on the {path} path")
        elif launches <= 0:
            failures.append(f"{name} was not launched on the {path} path")
    emit({"phase": "done", "seconds": time.time() - t_start})
    if failures:
        for f in failures:
            print("chip_smoke: FAILED:", f, file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
