"""Evaluation (inference) configurations: the port's copy of
``multimodal_fusion_fpn_tpu/eval/configs.py``.

Behavioral parity with the original project's ``test_config.py``,
including its MRO semantics: the registered opts inherit ``(DataConfig,
OptDefaults)`` with the *data config first*, so e.g. ``hrf``'s validation
metric set is HRFConfig's {Dice, BCE, Hausdorff, Hausdorff95}, its
Hausdorff distances on the host, and OptDefaults' richer set only applies
where no data config defines one (reference ``test_config.py:53-90``).
``vrc_lr2_comp_only`` therefore measures HRFConfig's set too (no global
metrics, the Hausdorff distances on the host); ``vrc`` defines its own:
Dice, Precision, Recall and IoU per image, and the seven global pixel
metrics of :mod:`..metrics.global_metrics` over the run.
"""

from multimodal_fusion_fpn_torch.metrics import global_metrics as G
from multimodal_fusion_fpn_torch.metrics import streaming as M
from multimodal_fusion_fpn_torch.registry import get_factory_adder
from multimodal_fusion_fpn_torch.train.configs import (
    HRFConfig, HRFFusionCompOnlyConfig, HRFFusionConfig, VRCVConfig,
    VRCVLR2CompOnlyConfig)

add_class, opt_factory = get_factory_adder()


class OptDefaults:
    results_path = "./__test/"
    models_path = "./__train/"
    which_model = "top-k"
    save_data = True

    def build_metrics_val(self):
        return {
            "Dice": M.Dice(output_key="prediction", target_key="mask",
                           slice=0),
            "BCE": M.BCE(output_key="prediction", target_key="mask",
                         slice=0),
            "Precision": M.Precision(output_key="prediction",
                                     target_key="mask"),
            "Recall": M.Recall(output_key="prediction", target_key="mask"),
            # device=True: the distances are computed on the card,
            # in the ensemble step (eval/ensemble.py,
            # make_ensemble_eval_step(with_hd=True)).
            "Hausdorff": M.Hausdorff(output_key="prediction",
                                     target_key="mask", slice=0,
                                     device=True),
            "Hausdorff95": M.Hausdorff95(output_key="prediction",
                                         target_key="mask", slice=0,
                                         device=True),
        }

    def __str__(self) -> str:
        attrs = {}
        for k in dir(self):
            if not k.startswith("__") and not callable(getattr(self, k)):
                attrs[k] = getattr(self, k)
        attrs.update({k: v for k, v in self.__dict__.items()
                      if not k.startswith("__")})
        out = f"# {self.__class__.__name__}:\n"
        for k, v in attrs.items():
            out += f"  * {k}: {v}\n"
        return out


@add_class("hrf")
class HRFOpt(HRFConfig, OptDefaults):
    pass


@add_class("hrf_fusion")
class HRFFusionOpt(HRFFusionConfig, OptDefaults):
    pass


@add_class("vrc")
class VRCOpt(VRCVConfig, OptDefaults):
    def build_global_metrics(self):
        return {
            "AUROC": G.AUROC(), "AUPR": G.AUPR(), "Sens": G.Sens(),
            "Spec": G.Spec(), "Acc": G.Acc(), "AP": G.AP(), "F1": G.F1(),
        }

    def build_metrics_val(self):
        return {
            "Dice": M.Dice(output_key="prediction", target_key="mask",
                           slice=0),
            "Precision": M.Precision(output_key="prediction",
                                     target_key="mask"),
            "Recall": M.Recall(output_key="prediction", target_key="mask"),
            "IoU": M.IoU(output_key="prediction", target_key="mask",
                         slice=0),
        }


@add_class("hrf_fusion_comp_only")
class HRFFusionCompOnlyOpt(HRFFusionCompOnlyConfig, OptDefaults):
    pass


@add_class("vrc_lr2_comp_only")
class VRCLR2CompOnlyOpt(VRCVLR2CompOnlyConfig, OptDefaults):
    pass
