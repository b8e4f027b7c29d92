"""Umbrella import for CSDL-alpha drivers on the port: the models of
goldfish_tpu_torch.csdl_models (port of goldfish_tpu/nonmatching_opt_csdl.py,
which mirrors the reference's GOLDFISH/nonmatching_opt_csdl.py:1-25) and the
system class. They run on real csdl_alpha where installed, else on the
port's shim.
"""

from goldfish_tpu_torch.csdl_models.models import (  # noqa: F401
    ComplianceModel,
    CPFE2IGAModel,
    CPFFD2SurfModel,
    CPFFDAlignModel,
    CPFFDPinModel,
    CPFFDReguModel,
    CPIGA2XiModel,
    DispMintStatesModel,
    DispStatesModel,
    HthFE2IGAModel,
    HthFFD2FEModel,
    HthFFDAlignModel,
    HthFFDReguModel,
    HthMapModel,
    IntEnergyModel,
    LinearMapModel,
    MaxvMStressModel,
    VMStressModel,
    VolumeModel,
)
from goldfish_tpu_torch.solver.system import NonMatchingSystem  # noqa: F401
