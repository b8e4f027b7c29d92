"""OpenMDAO thin adapters over the port's framework-agnostic operations.

Port of goldfish_tpu/om_comps/components.py, class for class, for the
fixed-intersection thickness path: `DispStatesComp` (implicit), the
objective components (`IntEnergyComp`, `VolumeComp`, `ComplianceComp`,
`MaxvMStressComp`) and the constant linear maps (`CPFE2IGAComp`,
`HthFE2IGAComp`, `HthFFD2FEComp`, `CPFFD2SurfComp`, `CPFFDAlignComp`,
`CPFFDPinComp`, `CPFFDReguComp`, `HthFFDAlignComp`, `HthFFDReguComp`,
`HthMapComp`). Real OpenMDAO is used when installed, else the port's
`om_shim` (the same API).

Dof vectors are flat real IGA dofs (node-major xyz) in numpy, as in the
JAX package; the operations move them to the system's device. There is no
FE/IGA split, so the *FE2IGA* comps are exact identity maps kept for graph
compatibility.
"""

from __future__ import annotations

import numpy as np

try:  # real OpenMDAO when installed; executing shim otherwise
    import openmdao.api as om
except ModuleNotFoundError:  # pragma: no cover - environment-dependent
    from goldfish_tpu_torch.om_shim import api as om

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.operations.disp_imop import DispImOperation
from goldfish_tpu_torch.operations.exops import (
    ComplianceExOperation,
    IntEnergyExOperation,
    MaxvMStressExOperation,
    VolumeExOperation,
)

__all__ = [
    "DispStatesComp", "IntEnergyComp", "VolumeComp", "ComplianceComp",
    "MaxvMStressComp", "CPFE2IGAComp", "HthFE2IGAComp", "HthFFD2FEComp",
    "HthMapComp", "CPFFD2SurfComp", "CPFFDAlignComp", "CPFFDPinComp",
    "CPFFDReguComp", "HthFFDAlignComp", "HthFFDReguComp",
]


def _flat(layout: CPLayout, padded):
    """Padded (P, C[, 3]) tensor -> flat numpy vector."""
    return layout.to_flat(padded).reshape(-1).cpu().numpy()


class DispStatesComp(om.ImplicitComponent):
    """Implicit displacement states."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("input_cp_name", default="CP_IGA")
        self.options.declare("input_h_th_name", default="thickness_IGA")
        self.options.declare("output_u_name", default="displacements")
        self.options.declare("rtol", default=1e-10)

    def init_parameters(self, save_files=False):
        self.op = DispImOperation(self.options["nonmatching_sys"],
                                  rtol=self.options["rtol"])
        self.cp_name = self.options["input_cp_name"]
        self.h_name = self.options["input_h_th_name"]
        self.u_name = self.options["output_u_name"]

    def setup(self):
        op = self.op
        self.add_input(self.cp_name, shape=op.vec_size,
                       val=_flat(op.layout, op.system.cp))
        self.add_input(self.h_name, shape=op.h_size,
                       val=_flat(op.layout, op.system.h_init))
        self.add_output(self.u_name, shape=op.vec_size)
        self.declare_partials(self.u_name, self.cp_name)
        self.declare_partials(self.u_name, self.h_name)
        self.declare_partials(self.u_name, self.u_name)

    def apply_nonlinear(self, inputs, outputs, residuals):
        residuals[self.u_name] = self.op.apply_nonlinear(
            inputs[self.cp_name], inputs[self.h_name], outputs[self.u_name])

    def solve_nonlinear(self, inputs, outputs):
        outputs[self.u_name] = self.op.solve_nonlinear(
            inputs[self.cp_name], inputs[self.h_name],
            outputs[self.u_name])

    def linearize(self, inputs, outputs, partials):
        self.op.linearize(inputs[self.cp_name], inputs[self.h_name],
                          outputs[self.u_name])

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        if mode == "fwd":
            d_residuals[self.u_name] += self.op.apply_linear_fwd(
                d_inputs.get(self.cp_name),
                d_inputs.get(self.h_name),
                d_outputs.get(self.u_name))
        else:
            cp_b, h_b, d_b = self.op.apply_linear_rev(
                d_residuals[self.u_name])
            if self.cp_name in d_inputs:
                d_inputs[self.cp_name] += cp_b
            if self.h_name in d_inputs:
                d_inputs[self.h_name] += h_b
            if self.u_name in d_outputs:
                d_outputs[self.u_name] += d_b

    def solve_linear(self, d_outputs, d_residuals, mode):
        if mode == "fwd":
            d_outputs[self.u_name] = self.op.solve_linear_fwd(
                d_residuals[self.u_name])
        else:
            d_residuals[self.u_name] = self.op.solve_linear_rev(
                d_outputs[self.u_name])


class _ObjectiveComp(om.ExplicitComponent):
    """Shared explicit-objective adapter (state + cp + h -> scalar)."""

    op_cls = None
    default_out = "objective"

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("input_cp_name", default="CP_IGA")
        self.options.declare("input_h_th_name", default="thickness_IGA")
        self.options.declare("input_u_name", default="displacements")
        self.options.declare("output_name", default=self.default_out)
        self.options.declare("op_kwargs", default={})

    def init_parameters(self):
        self.op = self.op_cls(self.options["nonmatching_sys"],
                              **self.options["op_kwargs"])
        self.cp_name = self.options["input_cp_name"]
        self.h_name = self.options["input_h_th_name"]
        self.u_name = self.options["input_u_name"]
        self.out_name = self.options["output_name"]

    def setup(self):
        op = self.op
        sys = self.options["nonmatching_sys"]
        n = op.layout.n_flat
        self.add_input(self.cp_name, shape=n * 3,
                       val=_flat(op.layout, sys.cp))
        self.add_input(self.h_name, shape=n, val=_flat(op.layout, sys.h_init))
        self.add_input(self.u_name, shape=n * 3)
        self.add_output(self.out_name)
        self.declare_partials(self.out_name, "*")

    def compute(self, inputs, outputs):
        outputs[self.out_name] = self.op.compute(
            inputs[self.cp_name], inputs[self.h_name], inputs[self.u_name])

    def compute_partials(self, inputs, partials):
        gcp, gh, gd = self.op.gradients(
            inputs[self.cp_name], inputs[self.h_name], inputs[self.u_name])
        partials[self.out_name, self.cp_name] = gcp
        partials[self.out_name, self.h_name] = gh
        partials[self.out_name, self.u_name] = gd


class IntEnergyComp(_ObjectiveComp):
    op_cls = IntEnergyExOperation
    default_out = "w_int"


class VolumeComp(_ObjectiveComp):
    op_cls = VolumeExOperation
    default_out = "volume"


class ComplianceComp(_ObjectiveComp):
    op_cls = ComplianceExOperation
    default_out = "compliance"


class MaxvMStressComp(_ObjectiveComp):
    op_cls = MaxvMStressExOperation
    default_out = "max_vmstress"


class _LinearMapComp(om.ExplicitComponent):
    """y = A x (+ b): all the constant sparse-matrix comps of the
    reference collapse to this one pattern."""

    def initialize(self):
        self.options.declare("A")
        self.options.declare("input_name")
        self.options.declare("output_name")
        self.options.declare("offset", default=None)

    def init_parameters(self):
        self.A = np.asarray(self.options["A"])
        self.in_name = self.options["input_name"]
        self.out_name = self.options["output_name"]
        self.offset = self.options["offset"]
        self.output_shape = self.A.shape[0]

    def setup(self):
        self.add_input(self.in_name, shape=self.A.shape[1])
        self.add_output(self.out_name, shape=self.A.shape[0])
        self.declare_partials(self.out_name, self.in_name, val=self.A)

    def compute(self, inputs, outputs):
        y = self.A @ inputs[self.in_name]
        if self.offset is not None:
            y = y + self.offset
        outputs[self.out_name] = y


class _IdentityComp(_LinearMapComp):
    """Exact identity: IGA dofs are THE dofs (no FE/IGA split)."""

    def initialize(self):
        super().initialize()
        self.options.declare("size")

    def init_parameters(self):
        self.options["A"] = np.eye(self.options["size"])
        super().init_parameters()


class CPFE2IGAComp(_IdentityComp):
    pass


class HthFE2IGAComp(_IdentityComp):
    pass


class HthFFD2FEComp(_LinearMapComp):
    """h_ffd -> flat thickness (A = ThicknessFFD.F, numpy)."""


class CPFFD2SurfComp(_LinearMapComp):
    """p_ffd -> flat surface CPs (A = FFDBlock.F per field)."""


class CPFFDAlignComp(_LinearMapComp):
    """A = design.constraints.align_operator."""


class CPFFDPinComp(_LinearMapComp):
    pass


class CPFFDReguComp(_LinearMapComp):
    pass


class HthFFDAlignComp(_LinearMapComp):
    pass


class HthFFDReguComp(_LinearMapComp):
    pass


class HthMapComp(_LinearMapComp):
    """Per-patch constant thickness -> flat per-CP thickness vector (a
    block of ones per patch)."""

    def initialize(self):
        super().initialize()
        self.options.declare("nonmatching_sys")
        self.options["input_name"] = "h_th"
        self.options["output_name"] = "h_th_iga"

    def init_parameters(self):
        sys = self.options["nonmatching_sys"]
        lay = CPLayout(sys.metas, sys.stack.max_cp, sys.device)
        P = sys.num_splines
        A = np.zeros((lay.n_flat, P))
        off = 0
        for p, m in enumerate(sys.metas):
            A[off:off + m.n_cp, p] = 1.0
            off += m.n_cp
        self.options["A"] = A
        super().init_parameters()
