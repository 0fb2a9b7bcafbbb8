"""Dataset / experiment configurations: the port's copy of the HRF half of
``multimodal_fusion_fpn_tpu/train/configs.py`` (the VRC configurations,
``vrc``, ``vrc_crop``, ``vrc_lr2`` and ``vrc_lr2_comp_only``, wait for the
port of the VRC dataset).

Behavioral parity with the original project's ``training_config.py``: the
same registry names (``hrf``, ``hrf_fusion``, ``hrf_fusion_comp_only``),
crop sizes, transform pipelines, loss factory and metric sets.  Unlike
the reference — which bakes the global config into *class bodies at import
time* (``training_config.py:229-233``) — these configs receive the parsed
config in ``__init__``, so flag handling has no import-order fragility.
"""

from typing import List, Optional

from multimodal_fusion_fpn_torch import losses
from multimodal_fusion_fpn_torch.metrics import streaming as M
from multimodal_fusion_fpn_torch.data import transforms as T
from multimodal_fusion_fpn_torch.data.hrf import HRF_SPEC_Dataset
from multimodal_fusion_fpn_torch.registry import get_factory_adder

add_class, data_config_factory = get_factory_adder()


class mmetric:
    def __init__(self, key="Dice"):
        self.key = key

    def get(self, m: dict):
        return m[self.key]


class DefaultConfig:
    s_size = 32   # number of B-scans in the training crop
    w_size = 128  # B-scan width in the training crop
    h_size: Optional[int] = None  # B-scan height (None: keep)
    batch_size = 8
    rate_mode = "minimum"
    monitor = "Dice"
    monitor_mode = "max"
    extra_transforms: List = []

    def __init__(self, config):
        self.config = config
        self.mask_variant = config.mask_variant
        self.fusion_modality = config.fusion_modality
        self.metrics_train = self.build_metrics_train()
        self.metrics_val = self.build_metrics_val()
        self.meta_metric_val = self.build_meta_metric_val()
        self.global_metrics = self.build_global_metrics()
        self.transformations = self.build_transformations()
        self.paths = self.build_paths()

    # -- pieces subclasses override ----------------------------------------
    def build_metrics_train(self):
        return {}

    def build_metrics_val(self):
        return {}

    def build_meta_metric_val(self):
        return {}

    def build_global_metrics(self):
        return {}

    def build_paths(self):
        return {"oct": None, "split": None, "visits": None}

    @staticmethod
    def identity_transforms():
        return {"normalization": [], "augmentation": []}

    def image_transformations(self, key="image"):
        return {
            "normalization": [
                T.ZScoreNormalization(transform_keys=[key], axis=(2, 3)),
            ],
            "augmentation": [
                T.MulNoiseAugmentation(transform_keys=[key], dim=(1,),
                                       mu=1.0, sigma=0.05),
                T.AddNoiseAugmentation(transform_keys=[key], dim=(0,),
                                       mu=0.0, sigma=0.2),
                T.ContrastAugmentation(transform_keys=[key],
                                       min=0.9, max=1.1),
                T.IntensityShift(transform_keys=[key], min=-0.2, max=0.2),
            ],
        }

    def slo_transformations(self, key="slo"):
        return {
            "normalization": [
                T.ZScoreNormalization(transform_keys=[key], axis=(1, 3)),
            ],
            "augmentation": [
                T.AddNoiseAugmentation(transform_keys=[key], dim=(0,),
                                       mu=0.0, sigma=0.12),
                T.ContrastAugmentation(transform_keys=[key],
                                       min=0.95, max=1.05),
                T.IntensityShift(transform_keys=[key], min=-0.07, max=0.07),
            ],
        }

    def build_transformations(self):
        return {
            "image": self.image_transformations(),
            "slo": self.slo_transformations(),
            "mask": self.identity_transforms(),
        }

    # -- API parity ----------------------------------------------------------
    def get_criterion(self):
        return losses.Mix(losses={
            "Dice Loss": losses.dice_loss_joint(output_key="prediction",
                                                target_key="mask"),
            "BCE loss": losses.bce_loss(output_key="prediction",
                                        target_key="mask"),
        })

    def get_val_transforms(self) -> T.Compose:
        keys = list(self.transformations.keys())
        data_transform_val = []
        for k in self.transformations:
            data_transform_val += self.transformations[k]["normalization"]
        data_transform_val += [
            T.NewRandomRelFit(transform_keys=keys,
                              fit=[None, 16, None, 16]),
            T.ToTensorDict(transform_keys=keys),
        ]
        return T.Compose(data_transform_val)

    def get_transforms(self):
        keys = list(self.transformations.keys())
        config = self.config

        crop_transforms: List[T.Transform] = [
            T.NewRandomRelCrop(reference_key="image", transform_keys=keys,
                               size=[None, self.s_size, self.h_size,
                                     self.w_size]),
        ]
        if config.crop.startswith("relative"):
            crop_transforms += [
                T.NewRandomRelSize(
                    transform_keys=[q for q in keys
                                    if q != config.fusion_modality],
                    fixed_size=[None, self.s_size, None, self.w_size]),
                # Fixed-size resize of the fusion modality so batches stack.
                T.NewRandomRelSize(
                    transform_keys=[config.fusion_modality],
                    fixed_size=[None, 320, None, 128]),
            ]
        else:
            crop_transforms.append(
                T.NewRandomRelSize(transform_keys=keys,
                                   fixed_size=[None, self.s_size, None,
                                               self.w_size]))

        data_transforms = list(crop_transforms)
        data_transforms.append(T.RandomRotation180(keys=keys))
        # Optional en-face rotation, only for crop='oct'
        # (reference training_config.py:156-159).
        if config.crop == "oct" and config.rotation_augmentation:
            data_transforms.append(T.RandomEnfaceRotation(keys=keys))
        data_transforms.append(
            T.RandomMirror(transform_keys=keys, dimensions=[1, 3]))
        for k in self.transformations:
            data_transforms += self.transformations[k]["normalization"]
            data_transforms += self.transformations[k]["augmentation"]
        data_transforms += self.extra_transforms
        data_transforms += [T.ToTensorDict(transform_keys=keys)]

        return T.Compose(data_transforms), self.get_val_transforms()


@add_class("hrf")
class HRFConfig(DefaultConfig):
    default_root = "../Multimodal_GA_seg_HRF"
    split_file = "split_1_full.json"
    visits_file = "hrf_data.json"

    def build_paths(self):
        import os
        root = self.config.data_root or self.default_root
        return {"oct": root,
                "split": os.path.join(root, self.split_file),
                "visits": os.path.join(root, self.visits_file)}

    def build_metrics_train(self):
        return {
            "Dice": M.Dice(output_key="prediction", target_key="mask"),
            "BCE": M.BCE(output_key="prediction", target_key="mask",
                         slice=0),
        }

    def build_metrics_val(self):
        return {
            "Dice": M.Dice(output_key="prediction", target_key="mask"),
            "BCE": M.BCE(output_key="prediction", target_key="mask",
                         slice=0),
            "Hausdorff": M.Hausdorff(output_key="prediction",
                                     target_key="mask", slice=0),
            "Hausdorff95": M.Hausdorff95(output_key="prediction",
                                         target_key="mask", slice=0),
        }

    def build_meta_metric_val(self):
        return {"Dice": mmetric()}

    def train_data(self, training_file_list, data_transform):
        return HRF_SPEC_Dataset(
            path=self.paths["oct"], patients=training_file_list,
            multiplier=self.config.multiplier, patches_from_single_image=1,
            transforms=data_transform, get_spacing=True,
            visits_fn=self.paths["visits"], mask_variant=self.mask_variant,
            crop=self.config.crop,
            fusion_modality=self.config.fusion_modality or "slo",
            debug=self.config.DEBUG)

    def val_data(self, validation_file_list, data_transform_val):
        return HRF_SPEC_Dataset(
            path=self.paths["oct"], patients=validation_file_list,
            multiplier=1, patches_from_single_image=1,
            transforms=data_transform_val, get_spacing=True,
            visits_fn=self.paths["visits"], mask_variant=self.mask_variant,
            crop=self.config.crop,
            fusion_modality=self.config.fusion_modality or "slo",
            debug=self.config.DEBUG)


@add_class("hrf_fusion")
class HRFFusionConfig(HRFConfig):
    def build_transformations(self):
        return {
            "image": self.image_transformations(),
            "mask": self.identity_transforms(),
            self.fusion_modality: self.identity_transforms(),
        }


@add_class("hrf_fusion_comp_only")
class HRFFusionCompOnlyConfig(HRFFusionConfig):
    def build_transformations(self):
        fm = self.fusion_modality
        return {
            "image": self.identity_transforms(),
            "mask": self.identity_transforms(),
            fm: {
                "normalization": [
                    T.ZScoreNormalization(transform_keys=[fm], axis=(1, 3)),
                ],
                "augmentation": [
                    T.MulNoiseAugmentation(transform_keys=[fm], dim=(1,),
                                           mu=1.0, sigma=0.05),
                    T.AddNoiseAugmentation(transform_keys=[fm], dim=(0,),
                                           mu=0.0, sigma=0.2),
                    T.ContrastAugmentation(transform_keys=[fm],
                                           min=0.9, max=1.1),
                    T.IntensityShift(transform_keys=[fm],
                                     min=-0.2, max=0.2),
                ],
            },
        }

    def get_val_transforms(self) -> T.Compose:
        keys = list(self.transformations.keys())
        data_transform_val = []
        for k in self.transformations:
            data_transform_val += self.transformations[k]["normalization"]
        data_transform_val += [
            T.Disable(keys=["image"]),
            T.NewRandomRelFit(transform_keys=[self.fusion_modality, "mask"],
                              fit=[None, 16, None, 16]),
            T.ToTensorDict(transform_keys=keys),
        ]
        return T.Compose(data_transform_val)

    def get_transforms(self):
        keys = list(self.transformations.keys())
        data_transforms: List[T.Transform] = [
            T.Disable(keys=["image"]),
            T.NewRandomRelSize(transform_keys=[self.fusion_modality, "mask"],
                               fixed_size=[None, 512, None, 512]),
            T.RandomRotation180(keys=keys),
            T.RandomEnfaceRotation(keys=keys, range=(-90, 90),
                                   probablity=0.9),
            T.RandomMirror(transform_keys=keys, dimensions=[1, 3]),
        ]
        for k in self.transformations:
            data_transforms += self.transformations[k]["normalization"]
            data_transforms += self.transformations[k]["augmentation"]
        data_transforms += self.extra_transforms
        data_transforms += [T.ToTensorDict(transform_keys=keys)]
        return T.Compose(data_transforms), self.get_val_transforms()
