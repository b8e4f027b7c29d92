"""The port's pegasus demo (goldfish_tpu_torch/demos/pegasus_thickness_opt.py)
on the CPU at the small box wing (n_sections=2, num_el=2, p=2): two SLSQP
iterations of minimum W_int at constant volume on the matrix-free route,
for the thickness FFD and for one thickness per patch. The optimizer must
lower W_int and hold the volume (linear in h) to 1e-9; no kernel launches
on CPU tensors."""

import numpy as np
import pytest
import torch


@pytest.mark.parametrize("const_th", [False, True])
def test_pegasus_demo_lowers_w_int_at_constant_volume(const_th):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import pegasus_thickness_opt as demo

    _cuda.reset_launch_counts()
    ns = demo.setup(n_sections=2, num_el=2, p=2, const_th=const_th,
                    route="krylov", device="cpu")
    with torch.no_grad():
        J0, _ = ns.obj({"h_ffd": torch.tensor(ns.x0)},
                       ns.sys.zero_displacement())
    res = ns.prob.run_slsqp(maxiter=2, tol=1e-12)
    with torch.no_grad():
        V1 = float(ns.vol({"h_ffd": torch.tensor(res.x["h_ffd"])}))
    assert res.nit >= 1 and np.isfinite(res.fun)
    assert res.fun < float(J0)
    assert abs(V1 - ns.V0) <= 1e-9 * ns.V0
    assert all(n == 0 for n in _cuda.launch_counts.values())
    assert ns.solve.solver.adjoint_cycles


def test_pegasus_demo_routes_agree():
    """The matrix-free and the dense route give the same W_int and gradient
    at the start design."""
    from goldfish_tpu_torch.demos import pegasus_thickness_opt as demo

    out = {}
    for route in ("krylov", "dense"):
        ns = demo.setup(n_sections=2, num_el=2, p=2, route=route,
                        device="cpu")
        x = torch.tensor(ns.x0, requires_grad=True)
        J, _ = ns.obj({"h_ffd": x}, ns.sys.zero_displacement())
        J.backward()
        out[route] = (float(J.detach()), x.grad.numpy())
    (Jk, gk), (Jd, gd) = out["krylov"], out["dense"]
    assert abs(Jk - Jd) <= 1e-9 * abs(Jd)
    assert np.linalg.norm(gk - gd) <= 1e-6 * np.linalg.norm(gd)
