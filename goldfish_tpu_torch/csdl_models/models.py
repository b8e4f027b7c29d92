"""CSDL-alpha thin adapters over the port's operations.

Port of goldfish_tpu/csdl_models/models.py: all nineteen models of the JAX
package's CSDL layer (the reference's 16 csdl_models, reference:
GOLDFISH/csdl_models/disp_states_model.py:58-177 CustomImplicitOperation
hooks, int_energy_model.py, volume_model.py, compliance_model.py,
vmstress_model.py, max_vmstress_model.py, cpfe2iga_model.py,
hthfe2iga_model.py, hth_map_model.py, cpffd2surf_model.py,
cpffd_align/pin/regu_model.py, hthffd2fe/align/regu_model.py; plus the
moving-intersection implicit models). Each is a thin shell over the port's
operations (goldfish_tpu_torch/operations/*), which take and return flat
numpy vectors and run on the system's device: in forward mode the implicit
models call the operations' `apply_linear_fwd` (the kernels' forward design
modes) and `solve_linear_fwd`, in reverse mode `apply_linear_rev` and
`solve_linear_rev`, accumulating into `d_inputs`. The models run on real
csdl_alpha where it is installed, else on the port's shim
(goldfish_tpu_torch/csdl_shim.py).
"""

from __future__ import annotations

import numpy as np

try:
    import csdl_alpha as csdl
except ModuleNotFoundError:
    from goldfish_tpu_torch import csdl_shim as csdl

from goldfish_tpu_torch.operations.disp_imop import DispImOperation
from goldfish_tpu_torch.operations.disp_mi_imop import (
    CPIGA2XiImOperation,
    DispMintImOperation,
)
from goldfish_tpu_torch.operations.exops import (
    ComplianceExOperation,
    IntEnergyExOperation,
    MaxvMStressExOperation,
    VMStressExOperation,
    VolumeExOperation,
)

__all__ = ["DispStatesModel", "DispMintStatesModel", "CPIGA2XiModel",
           "IntEnergyModel", "VolumeModel", "ComplianceModel",
           "VMStressModel", "MaxvMStressModel", "CPFE2IGAModel",
           "HthFE2IGAModel", "HthMapModel", "LinearMapModel",
           "CPFFD2SurfModel", "CPFFDAlignModel", "CPFFDPinModel",
           "CPFFDReguModel", "HthFFD2FEModel", "HthFFDAlignModel",
           "HthFFDReguModel"]


class DispStatesModel(csdl.experimental.CustomImplicitOperation):
    """Implicit displacement states (reference:
    csdl_models/disp_states_model.py)."""

    def __init__(self, nonmatching_sys, rtol=1e-10):
        super().__init__()
        self.op = DispImOperation(nonmatching_sys, rtol=rtol)

    def evaluate(self, cp, h_th):
        self.declare_input("CP_IGA", cp)
        self.declare_input("thickness_IGA", h_th)
        u = self.create_output("displacements", (self.op.vec_size,))
        self.declare_derivative_parameters(
            "displacements", "*", dependent=True)
        return u

    def solve_residual_equations(self, inputs, outputs):
        outputs["displacements"] = self.op.solve_nonlinear(
            inputs["CP_IGA"], inputs["thickness_IGA"],
            outputs.get("displacements"))
        self.op.linearize(inputs["CP_IGA"], inputs["thickness_IGA"],
                          outputs["displacements"])

    def compute_residual(self, inputs, outputs, residuals):
        residuals["displacements"] = self.op.apply_nonlinear(
            inputs["CP_IGA"], inputs["thickness_IGA"],
            outputs["displacements"])

    def compute_jacvec_product(self, inputs, outputs, d_inputs, d_outputs,
                               d_residuals, mode):
        self.op.linearize(inputs["CP_IGA"], inputs["thickness_IGA"],
                          outputs["displacements"])
        if mode == "fwd":
            d_residuals["displacements"] = self.op.apply_linear_fwd(
                d_inputs.get("CP_IGA"), d_inputs.get("thickness_IGA"),
                d_outputs.get("displacements"))
        else:
            cp_b, h_b, d_b = self.op.apply_linear_rev(
                d_residuals["displacements"])
            # ACCUMULATE, like the reference op layer's in-place `+=`
            # (reference: GOLDFISH/operations/disp_imop.py:115-127) and
            # the OM comps — assignment would drop contributions in
            # multi-consumer graphs
            if "CP_IGA" in d_inputs:
                d_inputs["CP_IGA"] = d_inputs["CP_IGA"] + cp_b
            if "thickness_IGA" in d_inputs:
                d_inputs["thickness_IGA"] = d_inputs["thickness_IGA"] + h_b
            if "displacements" in d_outputs:
                d_outputs["displacements"] = (
                    d_outputs["displacements"] + d_b)

    def apply_inverse_jacobian(self, inputs, outputs, d_outputs,
                               d_residuals, mode):
        if mode == "fwd":
            d_outputs["displacements"] = self.op.solve_linear_fwd(
                d_residuals["displacements"])
        else:
            d_residuals["displacements"] = self.op.solve_linear_rev(
                d_outputs["displacements"])


class DispMintStatesModel(csdl.experimental.CustomImplicitOperation):
    """Implicit displacement states with moving intersections: extra
    xi input (reference role: disp_states_model.py + the MI machinery
    of nonmatching_opt.py:1042-1341)."""

    def __init__(self, mi_sys, rtol=1e-10):
        super().__init__()
        self.op = DispMintImOperation(mi_sys, rtol=rtol)

    def evaluate(self, cp, h_th, xi):
        self.declare_input("CP_IGA", cp)
        self.declare_input("thickness_IGA", h_th)
        self.declare_input("int_para_coords", xi)
        u = self.create_output("displacements", (self.op.vec_size,))
        self.declare_derivative_parameters(
            "displacements", "*", dependent=True)
        return u

    def solve_residual_equations(self, inputs, outputs):
        outputs["displacements"] = self.op.solve_nonlinear(
            inputs["CP_IGA"], inputs["thickness_IGA"],
            inputs["int_para_coords"], outputs.get("displacements"))
        self.op.linearize(inputs["CP_IGA"], inputs["thickness_IGA"],
                          inputs["int_para_coords"],
                          outputs["displacements"])

    def compute_residual(self, inputs, outputs, residuals):
        residuals["displacements"] = self.op.apply_nonlinear(
            inputs["CP_IGA"], inputs["thickness_IGA"],
            inputs["int_para_coords"], outputs["displacements"])

    def compute_jacvec_product(self, inputs, outputs, d_inputs,
                               d_outputs, d_residuals, mode):
        self.op.linearize(inputs["CP_IGA"], inputs["thickness_IGA"],
                          inputs["int_para_coords"],
                          outputs["displacements"])
        if mode == "fwd":
            d_residuals["displacements"] = self.op.apply_linear_fwd(
                d_inputs.get("CP_IGA"), d_inputs.get("thickness_IGA"),
                d_inputs.get("int_para_coords"),
                d_outputs.get("displacements"))
        else:
            cp_b, h_b, xi_b, d_b = self.op.apply_linear_rev(
                d_residuals["displacements"])
            # accumulate (reference semantics; see DispStatesModel)
            if "CP_IGA" in d_inputs:
                d_inputs["CP_IGA"] = d_inputs["CP_IGA"] + cp_b
            if "thickness_IGA" in d_inputs:
                d_inputs["thickness_IGA"] = d_inputs["thickness_IGA"] + h_b
            if "int_para_coords" in d_inputs:
                d_inputs["int_para_coords"] = (
                    d_inputs["int_para_coords"] + xi_b)
            if "displacements" in d_outputs:
                d_outputs["displacements"] = (
                    d_outputs["displacements"] + d_b)

    def apply_inverse_jacobian(self, inputs, outputs, d_outputs,
                               d_residuals, mode):
        if mode == "fwd":
            d_outputs["displacements"] = self.op.solve_linear_fwd(
                d_residuals["displacements"])
        else:
            d_residuals["displacements"] = self.op.solve_linear_rev(
                d_outputs["displacements"])


class CPIGA2XiModel(csdl.experimental.CustomImplicitOperation):
    """Implicit CP -> xi solve (reference role:
    operations/cpiga2xi_imop.py wrapped for csdl)."""

    def __init__(self, mi_sys):
        super().__init__()
        self.op = CPIGA2XiImOperation(mi_sys)

    def evaluate(self, cp):
        self.declare_input("CP_IGA", cp)
        xi = self.create_output("int_para_coords", (self.op.xi_size,))
        self.declare_derivative_parameters(
            "int_para_coords", "*", dependent=True)
        return xi

    def solve_residual_equations(self, inputs, outputs):
        outputs["int_para_coords"] = self.op.solve_nonlinear(
            inputs["CP_IGA"])
        self.op.linearize(inputs["CP_IGA"], outputs["int_para_coords"])

    def compute_residual(self, inputs, outputs, residuals):
        residuals["int_para_coords"] = self.op.apply_nonlinear(
            inputs["CP_IGA"], outputs["int_para_coords"])

    def compute_jacvec_product(self, inputs, outputs, d_inputs,
                               d_outputs, d_residuals, mode):
        self.op.linearize(inputs["CP_IGA"], outputs["int_para_coords"])
        if mode == "fwd":
            d_residuals["int_para_coords"] = self.op.apply_linear_fwd(
                d_inputs.get("CP_IGA"),
                d_outputs.get("int_para_coords"))
        else:
            cp_b, xi_b = self.op.apply_linear_rev(
                d_residuals["int_para_coords"])
            # accumulate (reference semantics; see DispStatesModel)
            if "CP_IGA" in d_inputs:
                d_inputs["CP_IGA"] = d_inputs["CP_IGA"] + cp_b
            if "int_para_coords" in d_outputs:
                d_outputs["int_para_coords"] = (
                    d_outputs["int_para_coords"] + xi_b)

    def apply_inverse_jacobian(self, inputs, outputs, d_outputs,
                               d_residuals, mode):
        if mode == "fwd":
            d_outputs["int_para_coords"] = self.op.solve_linear_fwd(
                d_residuals["int_para_coords"])
        else:
            d_residuals["int_para_coords"] = self.op.solve_linear_rev(
                d_outputs["int_para_coords"])


class _ScalarExOpModel(csdl.CustomExplicitOperation):
    """Shared csdl adapter for scalar explicit operations."""

    out_name = "objective"
    op_cls = None

    def __init__(self, nonmatching_sys, **kw):
        super().__init__()
        self.op = self.op_cls(nonmatching_sys, **kw)

    def evaluate(self, cp, h_th, u):
        self.declare_input("CP_IGA", cp)
        self.declare_input("thickness_IGA", h_th)
        self.declare_input("displacements", u)
        return self.create_output(self.out_name, (1,))

    def compute(self, inputs, outputs):
        outputs[self.out_name] = np.array([self.op.compute(
            inputs["CP_IGA"], inputs["thickness_IGA"],
            inputs["displacements"])])

    def compute_derivatives(self, inputs, outputs, derivs):
        g = self.op.gradients(inputs["CP_IGA"],
                              inputs["thickness_IGA"],
                              inputs["displacements"])
        derivs[self.out_name, "CP_IGA"] = g[0][None, :]
        derivs[self.out_name, "thickness_IGA"] = g[1][None, :]
        derivs[self.out_name, "displacements"] = g[2][None, :]


class IntEnergyModel(_ScalarExOpModel):
    out_name = "w_int"
    op_cls = IntEnergyExOperation


class VolumeModel(_ScalarExOpModel):
    out_name = "volume"
    op_cls = VolumeExOperation


class ComplianceModel(_ScalarExOpModel):
    out_name = "compliance"
    op_cls = ComplianceExOperation


class MaxvMStressModel(_ScalarExOpModel):
    out_name = "max_vmstress"
    op_cls = MaxvMStressExOperation


class VMStressModel(csdl.CustomExplicitOperation):
    """Per-quadrature-point von Mises stress VECTOR (reference:
    csdl_models/vmstress_model.py:1-331 — the per-patch stress field,
    not only the aggregate)."""

    def __init__(self, nonmatching_sys, through="top"):
        super().__init__()
        self.op = VMStressExOperation(nonmatching_sys, through=through)

    def evaluate(self, cp, h_th, u):
        self.declare_input("CP_IGA", cp)
        self.declare_input("thickness_IGA", h_th)
        self.declare_input("displacements", u)
        return self.create_output("von_mises_stress",
                                  (self.op.out_size,))

    def compute(self, inputs, outputs):
        outputs["von_mises_stress"] = self.op.compute(
            inputs["CP_IGA"], inputs["thickness_IGA"],
            inputs["displacements"])

    def compute_derivatives(self, inputs, outputs, derivs):
        Jcp, Jh, Ju = self.op.jacobians(
            inputs["CP_IGA"], inputs["thickness_IGA"],
            inputs["displacements"])
        derivs["von_mises_stress", "CP_IGA"] = Jcp
        derivs["von_mises_stress", "thickness_IGA"] = Jh
        derivs["von_mises_stress", "displacements"] = Ju


class LinearMapModel:
    """y = A x as a csdl matvec (all constant-matrix models: hth_map,
    cpffd2surf, align/pin/regu, fe2iga identities)."""

    def __init__(self, A):
        self.A = np.asarray(A)

    def evaluate(self, x):
        return csdl.matvec(csdl.Variable(value=self.A), x)


class CPFE2IGAModel(LinearMapModel):
    """Exact identity (no FE space in this build; reference:
    csdl_models/cpfe2iga_model.py pseudo-inverse collapses)."""

    def __init__(self, size):
        super().__init__(np.eye(size))


class HthFE2IGAModel(CPFE2IGAModel):
    pass


class HthMapModel(LinearMapModel):
    """Per-patch constant thickness -> flat thickness vector
    (reference: csdl_models/hth_map_model.py — block-of-ones map)."""

    def __init__(self, nonmatching_sys):
        from goldfish_tpu_torch.design.pipeline import CPLayout

        lay = CPLayout(nonmatching_sys.metas, nonmatching_sys.stack.max_cp,
                       nonmatching_sys.device)
        P = nonmatching_sys.num_splines
        A = np.zeros((lay.n_flat, P))
        for i, n in enumerate(lay.n_per_patch):
            A[lay.offsets[i]: lay.offsets[i + 1], i] = 1.0
        super().__init__(A)


class CPFFD2SurfModel(LinearMapModel):
    """FFD block coefficients -> surface CPs (reference:
    csdl_models/cpffd2surf_model.py; A = ShapeFFD.F per field)."""


class CPFFDAlignModel(LinearMapModel):
    """(reference: csdl_models/cpffd_align_model.py)"""


class CPFFDPinModel(LinearMapModel):
    """(reference: csdl_models/cpffd_pin_model.py)"""


class CPFFDReguModel(LinearMapModel):
    """(reference: csdl_models/cpffd_regu_model.py)"""


class HthFFD2FEModel(LinearMapModel):
    """(reference: csdl_models/hthffd2fe_model.py; A = ThicknessFFD.F)"""


class HthFFDAlignModel(LinearMapModel):
    """(reference: csdl_models/hthffd_align_model.py)"""


class HthFFDReguModel(LinearMapModel):
    """(reference: csdl_models/hthffd_regu_model.py)"""
