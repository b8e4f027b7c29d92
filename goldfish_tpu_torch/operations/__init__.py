from goldfish_tpu_torch.operations.disp_imop import DispImOperation
from goldfish_tpu_torch.operations.exops import (
    ComplianceExOperation,
    IntEnergyExOperation,
    MaxvMStressExOperation,
    VolumeExOperation,
)

__all__ = [
    "DispImOperation",
    "IntEnergyExOperation",
    "VolumeExOperation",
    "ComplianceExOperation",
    "MaxvMStressExOperation",
]
