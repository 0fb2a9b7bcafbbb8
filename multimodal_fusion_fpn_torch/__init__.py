"""PyTorch / CUDA port of ``multimodal_fusion_fpn_tpu`` for NVIDIA Hopper.

A second package beside the JAX one: it imports ``torch`` and nothing of
JAX or of the JAX package.  Tensors inside are channels-last, as in the
JAX package; the public batch layout is the original project's.  The
kernels the JAX package wrote in Pallas for the TPU are hand-written CUDA
here (``csrc/``, built on first use into ``build/kernels/``), each beside
a plain PyTorch version that the CPU takes.

Ported so far: the 8 zoo models (:func:`models.zoo.build_model`), their
ensemble inference (:func:`eval.ensemble.make_ensemble_eval_step`), exact
shape-bucketed serving (:func:`eval.harness.evaluate`), the train step
(:func:`train.step.make_train_step`), and the serving entry point
(:mod:`validate_ensemble`, ``python -m
multimodal_fusion_fpn_torch.validate_ensemble``) over the HRF data
pipeline (:mod:`data`), the configs, the noise, the checkpoints and the
harness's artifacts.  Not yet: the VRC dataset, the trainer and its
entry point, ``viz.py`` and the data x space mesh.
"""

__version__ = "0.1.0"
