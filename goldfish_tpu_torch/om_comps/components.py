"""OpenMDAO thin adapters over the port's framework-agnostic operations.

Port of goldfish_tpu/om_comps/components.py, class for class: the
fixed-intersection thickness path's `DispStatesComp` (implicit), the
objective components (`IntEnergyComp`, `VolumeComp`, `ComplianceComp`,
`MaxvMStressComp`), the stress field `VMStressComp` and the constant linear maps (`CPFE2IGAComp`,
`HthFE2IGAComp`, `HthFFD2FEComp`, `CPFFD2SurfComp`, `CPFFDAlignComp`,
`CPFFDPinComp`, `CPFFDReguComp`, `HthFFDAlignComp`, `HthFFDReguComp`,
`HthMapComp`); the moving-intersection shape path's implicit
`CPIGA2XiComp` and `DispMintStatesComp`, the `IntXiEdgeComp` constraint
the design-surface pipeline over `CPSurfDesign2Analysis`
(`CPSurfOrderElevationComp`, `CPSurfKnotRefienmentComp`, `CPSurfAlignComp`,
`CPSurfReguComp`, `CPSurfPinComp`, `CPSurfDistanceComp`); the KS
aggregations (`MaxIntXiComp`, `MinIntXiComp`, `CPFFDReguCompAgg`) and the
regularized objective `IntEnergyReguComp`. Real OpenMDAO is used when
installed, else the port's `om_shim` (the same API).

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
from goldfish_tpu_torch.geometry.cpiga2xi import xi_edge_constraints
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
    VMStressExOperation,
    VolumeExOperation,
)

__all__ = [
    "DispStatesComp", "DispMintStatesComp", "CPIGA2XiComp", "IntXiEdgeComp",
    "IntEnergyComp", "IntEnergyReguComp", "VolumeComp", "ComplianceComp",
    "MaxvMStressComp", "VMStressComp", "CPFE2IGAComp", "HthFE2IGAComp", "HthFFD2FEComp",
    "HthMapComp", "CPFFD2SurfComp", "CPFFDAlignComp", "CPFFDPinComp",
    "CPFFDReguComp", "HthFFDAlignComp", "HthFFDReguComp",
    "CPSurfAlignComp", "CPSurfOrderElevationComp", "CPSurfKnotRefienmentComp",
    "CPSurfKnotRefinementComp", "CPSurfReguComp", "CPSurfPinComp",
    "CPSurfDistanceComp", "MaxIntXiComp", "MinIntXiComp", "CPFFDReguCompAgg",
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


class CPIGA2XiComp(om.ImplicitComponent):
    """Implicit CP -> xi solve (the reference's cpiga2xi_comp)."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("input_cp_name", default="CP_IGA")
        self.options.declare("output_xi_name", default="int_para_coords")

    def init_parameters(self):
        self.op = CPIGA2XiImOperation(self.options["nonmatching_sys"])
        self.cp_name = self.options["input_cp_name"]
        self.xi_name = self.options["output_xi_name"]

    def setup(self):
        op = self.op
        self.add_input(self.cp_name, shape=op.layout.n_flat * 3,
                       val=_flat(op.layout, op.sys.cp))
        self.add_output(self.xi_name, shape=op.xi_size,
                        val=op.c2x.xi0_flat.reshape(-1).cpu().numpy())
        self.declare_partials(self.xi_name, self.cp_name)
        self.declare_partials(self.xi_name, self.xi_name)

    def apply_nonlinear(self, inputs, outputs, residuals):
        residuals[self.xi_name] = self.op.apply_nonlinear(
            inputs[self.cp_name], outputs[self.xi_name])

    def solve_nonlinear(self, inputs, outputs):
        outputs[self.xi_name] = self.op.solve_nonlinear(
            inputs[self.cp_name])

    def linearize(self, inputs, outputs, partials):
        self.op.linearize(inputs[self.cp_name], outputs[self.xi_name])

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        if mode == "fwd":
            d_residuals[self.xi_name] += self.op.apply_linear_fwd(
                d_inputs.get(self.cp_name), d_outputs.get(self.xi_name))
        else:
            cp_b, xi_b = self.op.apply_linear_rev(
                d_residuals[self.xi_name])
            if self.cp_name in d_inputs:
                d_inputs[self.cp_name] += cp_b
            if self.xi_name in d_outputs:
                d_outputs[self.xi_name] += xi_b

    def solve_linear(self, d_outputs, d_residuals, mode):
        if mode == "fwd":
            d_outputs[self.xi_name] = self.op.solve_linear_fwd(
                d_residuals[self.xi_name])
        else:
            d_residuals[self.xi_name] = self.op.solve_linear_rev(
                d_outputs[self.xi_name])


class DispMintStatesComp(om.ImplicitComponent):
    """Implicit displacement states with moving intersections (the
    reference's disp_states_mi_comp: its update_xi and transfer-matrix
    machinery is the xi-parametrized residual of solver/system_mi.py)."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("input_cp_name", default="CP_IGA")
        self.options.declare("input_h_th_name", default="thickness_IGA")
        self.options.declare("input_xi_name", default="int_para_coords")
        self.options.declare("output_u_name", default="displacements")
        self.options.declare("rtol", default=1e-10)

    def init_parameters(self, save_files=False):
        self.op = DispMintImOperation(self.options["nonmatching_sys"],
                                      rtol=self.options["rtol"])
        self.cp_name = self.options["input_cp_name"]
        self.h_name = self.options["input_h_th_name"]
        self.xi_name = self.options["input_xi_name"]
        self.u_name = self.options["output_u_name"]

    def setup(self):
        op = self.op
        sys = op.sys
        self.add_input(self.cp_name, shape=op.vec_size,
                       val=_flat(op.layout, sys.cp))
        self.add_input(self.h_name, shape=op.h_size,
                       val=_flat(op.layout, sys.h_init))
        self.add_input(self.xi_name, shape=int(np.prod(op.xi_shape)),
                       val=sys.c2x.xi0_flat.reshape(-1).cpu().numpy())
        self.add_output(self.u_name, shape=op.vec_size)
        self.declare_partials(self.u_name, "*")

    def apply_nonlinear(self, inputs, outputs, residuals):
        residuals[self.u_name] = self.op.apply_nonlinear(
            inputs[self.cp_name], inputs[self.h_name],
            inputs[self.xi_name], outputs[self.u_name])

    def solve_nonlinear(self, inputs, outputs):
        outputs[self.u_name] = self.op.solve_nonlinear(
            inputs[self.cp_name], inputs[self.h_name],
            inputs[self.xi_name], outputs[self.u_name])

    def linearize(self, inputs, outputs, partials):
        self.op.linearize(inputs[self.cp_name], inputs[self.h_name],
                          inputs[self.xi_name], outputs[self.u_name])

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        if mode == "fwd":
            d_residuals[self.u_name] += self.op.apply_linear_fwd(
                d_inputs.get(self.cp_name), d_inputs.get(self.h_name),
                d_inputs.get(self.xi_name), d_outputs.get(self.u_name))
        else:
            cp_b, h_b, xi_b, d_b = self.op.apply_linear_rev(
                d_residuals[self.u_name])
            for name, bar in ((self.cp_name, cp_b), (self.h_name, h_b),
                              (self.xi_name, xi_b)):
                if name in d_inputs:
                    d_inputs[name] += bar
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


class IntEnergyReguComp(_ObjectiveComp):
    """W_int + the CP-smoothness regularization (the reference eVTOL
    driver's objective); op_kwargs=dict(regu_para=...) sets the penalty
    weight."""

    op_cls = IntEnergyReguExOperation
    default_out = "w_int_regu"


class VolumeComp(_ObjectiveComp):
    op_cls = VolumeExOperation
    default_out = "volume"


class ComplianceComp(_ObjectiveComp):
    op_cls = ComplianceExOperation
    default_out = "compliance"


class MaxvMStressComp(_ObjectiveComp):
    op_cls = MaxvMStressExOperation
    default_out = "max_vmstress"


class VMStressComp(om.ExplicitComponent):
    """Per-quadrature-point von Mises stress VECTOR output, with dense
    partials (K9 modes 0 and 2 on the card)."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("input_cp_name", default="CP_IGA")
        self.options.declare("input_h_th_name", default="thickness_IGA")
        self.options.declare("input_u_name", default="displacements")
        self.options.declare("output_name", default="von_mises_stress")
        self.options.declare("through", default="top")

    def init_parameters(self):
        self.op = VMStressExOperation(self.options["nonmatching_sys"],
                                      through=self.options["through"])
        self.cp_name = self.options["input_cp_name"]
        self.h_name = self.options["input_h_th_name"]
        self.u_name = self.options["input_u_name"]
        self.out_name = self.options["output_name"]

    def setup(self):
        op = self.op
        sys_ = self.options["nonmatching_sys"]
        n = op.layout.n_flat
        self.add_input(self.cp_name, shape=n * 3,
                       val=_flat(op.layout, sys_.cp))
        self.add_input(self.h_name, shape=n,
                       val=_flat(op.layout, sys_.h_init[..., None]))
        self.add_input(self.u_name, shape=n * 3)
        self.add_output(self.out_name, shape=op.out_size)
        self.declare_partials(self.out_name, "*")

    def compute(self, inputs, outputs):
        outputs[self.out_name] = self.op.compute(
            inputs[self.cp_name], inputs[self.h_name], inputs[self.u_name])

    def compute_partials(self, inputs, partials):
        Jcp, Jh, Ju = self.op.jacobians(
            inputs[self.cp_name], inputs[self.h_name], inputs[self.u_name])
        partials[self.out_name, self.cp_name] = Jcp
        partials[self.out_name, self.h_name] = Jh
        partials[self.out_name, self.u_name] = Ju


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


class IntXiEdgeComp(om.ExplicitComponent):
    """Edge-type xi equality constraint: xi[edge dofs] - edge vals = 0 with
    a constant 0/1 Jacobian (the reference's int_xi_edge_comp)."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("input_xi_name", default="int_para_coords")
        self.options.declare("output_name", default="int_xi_edge")

    def init_parameters(self):
        sys = self.options["nonmatching_sys"]
        self.xi_name = self.options["input_xi_name"]
        self.out_name = self.options["output_name"]
        self.xi_size = int(sys.c2x.xi0_flat.numel())
        self.dofs, self.vals = xi_edge_constraints(sys.mi)
        self.output_shape = len(self.dofs)

    def setup(self):
        n = max(self.output_shape, 1)
        self.add_input(self.xi_name, shape=self.xi_size)
        self.add_output(self.out_name, shape=n)
        A = np.zeros((n, self.xi_size))
        A[np.arange(self.output_shape), self.dofs] = 1.0
        self.declare_partials(self.out_name, self.xi_name, val=A)

    def compute(self, inputs, outputs):
        if self.output_shape:
            outputs[self.out_name] = (
                inputs[self.xi_name][self.dofs] - self.vals)


class _KSAggComp(om.ExplicitComponent):
    """Scalar KS (log-sum-exp) aggregation of a vector input, the shared
    body of `MaxIntXiComp`, `MinIntXiComp` and `CPFFDReguCompAgg`:

        sign = +1: smooth max  KS(x) = m + log(sum exp(rho (x - m))) / rho
        sign = -1: smooth min  -KS(-x)

    with m the largest entry (max-shifted, so no exponential overflows),
    optionally of the rows A @ x of a constant operator A. The partials are
    the softmax weights (times A). Host NumPy."""

    sign = 1.0

    def initialize(self):
        self.options.declare("input_name", default="int_para_coords")
        self.options.declare("output_name", default="ks_agg")
        self.options.declare("input_shape", default=None)
        self.options.declare("rho", default=50.0)
        self.options.declare("A", default=None)

    def init_parameters(self, input_shape=None):
        if input_shape is not None:
            self.options["input_shape"] = int(input_shape)
        self.in_name = self.options["input_name"]
        self.out_name = self.options["output_name"]
        self.rho = float(self.options["rho"])
        A = self.options["A"]
        self._A = None if A is None else np.asarray(A, dtype=np.float64)
        if self._A is not None:
            self.options["input_shape"] = self._A.shape[1]

    def setup(self):
        self.add_input(self.in_name, shape=self.options["input_shape"])
        self.add_output(self.out_name)
        self.declare_partials(self.out_name, self.in_name)

    def _shifted(self, inputs):
        x = inputs[self.in_name]
        y = self.sign * (x if self._A is None else self._A @ x)
        m = y.max()
        return m, np.exp(self.rho * (y - m))

    def compute(self, inputs, outputs):
        m, e = self._shifted(inputs)
        outputs[self.out_name] = self.sign * (m + np.log(e.sum()) / self.rho)

    def compute_partials(self, inputs, partials):
        _, e = self._shifted(inputs)
        w = e / e.sum()  # softmax weights; the sign cancels (sign^2 = 1)
        partials[self.out_name, self.in_name] = \
            w if self._A is None else w @ self._A


class MaxIntXiComp(_KSAggComp):
    """Smooth max over the moving intersections' parametric coordinates;
    constrain <= 1 - eps to keep every xi inside its patch."""

    sign = 1.0

    def initialize(self):
        super().initialize()
        self.options["output_name"] = "max_int_xi"


class MinIntXiComp(_KSAggComp):
    """Smooth min of the xi vector; constrain >= eps."""

    sign = -1.0

    def initialize(self):
        super().initialize()
        self.options["output_name"] = "min_int_xi"


class CPFFDReguCompAgg(_KSAggComp):
    """Aggregated FFD regularization: the smooth min over the
    first-difference rows A @ p_ffd (A from
    `design.constraints.regu_operator`), constrained >= eps; one scalar
    row replaces the per-difference inequality block."""

    sign = -1.0

    def initialize(self):
        super().initialize()
        self.options["input_name"] = "p_ffd"
        self.options["output_name"] = "cpffd_regu_agg"


class _SurfPipelineComp(_LinearMapComp):
    """Base of the CPSurfDesign2Analysis comps (the reference's
    surf_comps): a constant per-surface operator, block-diagonal over the
    optimized surfaces and stacked over fields. `matrix_of(d2a, i)` gives
    surface i's matrix."""

    matrix_of = None

    def initialize(self):
        super().initialize()
        self.options.declare("design2analysis")
        self.options.declare("fields", default=(0, 1, 2))

    def init_parameters(self):
        d2a = self.options["design2analysis"]
        mats = [np.asarray(self.matrix_of(d2a, i)) for i in d2a.surf_inds]
        blk = np.zeros((sum(m.shape[0] for m in mats),
                        sum(m.shape[1] for m in mats)))
        ro = co = 0
        for m in mats:
            blk[ro:ro + m.shape[0], co:co + m.shape[1]] = m
            ro += m.shape[0]
            co += m.shape[1]
        self.options["A"] = np.kron(np.eye(len(self.options["fields"])), blk)
        super().init_parameters()


class CPSurfAlignComp(_SurfPipelineComp):
    """Design-grid CP alignment rows along `align_axis`."""

    def initialize(self):
        super().initialize()
        self.options.declare("align_axis", default=0)

    def init_parameters(self):
        axis = self.options["align_axis"]
        self.matrix_of = lambda d2a, i: d2a.align_rows(i, axis)
        super().init_parameters()


class CPSurfOrderElevationComp(_SurfPipelineComp):
    """Design CP -> order-elevated CP."""

    matrix_of = staticmethod(lambda d2a, i: d2a.elevation_matrix(i))


class CPSurfKnotRefienmentComp(_SurfPipelineComp):
    """Elevated CP -> analysis CP (the reference's file name kept:
    cpsurf_knot_refienment_comp)."""

    matrix_of = staticmethod(lambda d2a, i: d2a.refinement_matrix(i))


class CPSurfReguComp(_SurfPipelineComp):
    """Consecutive-difference regularization rows along `regu_axis` (use
    as >= eps)."""

    def initialize(self):
        super().initialize()
        self.options.declare("regu_axis", default=0)

    def init_parameters(self):
        axis = self.options["regu_axis"]
        self.matrix_of = lambda d2a, i: d2a.regu_rows(i, axis)
        super().init_parameters()


class CPSurfPinComp(_SurfPipelineComp):
    """Pinned design-dof selection rows (`pinned`: surface -> dofs)."""

    def initialize(self):
        super().initialize()
        self.options.declare("pinned", default={})

    def init_parameters(self):
        pinned = self.options["pinned"]
        self.matrix_of = lambda d2a, i: d2a.pin_rows(i, pinned.get(i, ()))
        super().init_parameters()


class CPSurfDistanceComp(_LinearMapComp):
    """Design-CP distance rows between one surface pair (`pair`), from
    `CPSurfDesign2Analysis.dist_rows`."""

    def initialize(self):
        super().initialize()
        self.options.declare("design2analysis")
        self.options.declare("pair", default=(0, 1))

    def init_parameters(self):
        d2a = self.options["design2analysis"]
        i, j = self.options["pair"]
        self.options["A"] = d2a.dist_rows(i, j)
        super().init_parameters()


CPSurfKnotRefinementComp = CPSurfKnotRefienmentComp  # corrected-name alias
