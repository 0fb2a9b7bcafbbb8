from multimodal_fusion_fpn_torch.data import transforms  # noqa: F401
from multimodal_fusion_fpn_torch.data.abstract import \
    AbstractDataset  # noqa: F401
from multimodal_fusion_fpn_torch.data.hrf import HRF_SPEC_Dataset  # noqa: F401
from multimodal_fusion_fpn_torch.data.vrc import VRC_Dataset  # noqa: F401
from multimodal_fusion_fpn_torch.data.loader import DataLoader  # noqa: F401
