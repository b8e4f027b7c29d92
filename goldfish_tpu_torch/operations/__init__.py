from goldfish_tpu_torch.operations.disp_imop import DispImOperation
from goldfish_tpu_torch.operations.disp_mi_imop import (
    CPIGA2XiImOperation,
    DispMintImOperation,
)
from goldfish_tpu_torch.operations.exops import (
    ComplianceExOperation,
    IntEnergyExOperation,
    IntEnergyReguExOperation,
    MaxvMStressExOperation,
    VolumeExOperation,
)

__all__ = [
    "DispImOperation",
    "DispMintImOperation",
    "CPIGA2XiImOperation",
    "IntEnergyExOperation",
    "IntEnergyReguExOperation",
    "VolumeExOperation",
    "ComplianceExOperation",
    "MaxvMStressExOperation",
]
