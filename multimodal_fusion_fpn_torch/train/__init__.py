"""Training of the port: optimizer, state, the train step, the trainer and
the entry point (``python -m multimodal_fusion_fpn_torch.train``)."""


def run(argv=None, device="cuda", kernels: bool = True):
    """The entry point's :func:`~multimodal_fusion_fpn_torch.train.
    __main__.run` (imported when called, so ``python -m`` runs the module
    once)."""
    from multimodal_fusion_fpn_torch.train.__main__ import run as _run
    return _run(argv, device=device, kernels=kernels)
