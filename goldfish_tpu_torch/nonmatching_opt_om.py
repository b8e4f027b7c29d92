"""Umbrella import for OpenMDAO drivers on the port: the components of
goldfish_tpu_torch.om_comps (the fixed-intersection thickness and shape
path; the moving-intersection and surface/KS components are still to be
ported, ROADMAP Queue A) and the system class.
"""

from goldfish_tpu_torch.om_comps.components import (  # noqa: F401
    ComplianceComp,
    CPFE2IGAComp,
    CPFFD2SurfComp,
    CPFFDAlignComp,
    CPFFDPinComp,
    CPFFDReguComp,
    DispStatesComp,
    HthFE2IGAComp,
    HthFFD2FEComp,
    HthFFDAlignComp,
    HthFFDReguComp,
    HthMapComp,
    IntEnergyComp,
    MaxvMStressComp,
    VolumeComp,
)
from goldfish_tpu_torch.solver.system import NonMatchingSystem  # noqa: F401
