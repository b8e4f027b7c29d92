"""Redesigned kernels at their main paths' shapes, on the GPU, for A/B runs
of two trees.

`--what k1k4`: K1's Hessian mode and K4 at the wing20 main path's shapes.
Times K1 `shell_qp/hess` and K4 `jet_matvec` of one tree's
`goldfish_tpu_torch` on the 20-patch wing (wing.build(num_el=6, p=3), N =
6600, 17,920 shell qps, 992 interface qps) at chip_smoke.py phase 3's
seeded state, two ways: back to back (CUDA events around `--launches`
launches: the inputs may stay in the 50 MB L2) and cold (each launch after
writing a 256 MB scratch tensor outside the timed window: in the solver's
IR loop every K4 call follows a substitution that streams the 348 MB
factor, so its 48.8 MB of jets come from device memory). K4 is timed as
chip_smoke.py times it (y zeroed, then one launch per group: shell and
interface) and per group. Where the tree's K4 source lets a build replace
its table of compile-time shapes, K4's C entry is also built with an empty
table (into this checkout's gitignored `goldfish_tpu_torch/_build/`), so
that every group runs the runtime-shape instantiation, and timed the same
ways beside the compiled one (`jet_matvec[runtime-shape]`).

`--what contact`: K12 through its public entry points, `contact_value_grad`,
`contact_hvp` and `contact_hess` (into a zeroed K, the zero-fill timed
with it), on the two-plate press at num_el=16 and 32 (chip_smoke.py's
`press_problem`) at its continuation equilibrium (4 levels) plus the
smoke's seeded noise (`check_contact`), with the same calls on both trees
(cells of 16 qps where a tree culls); where the tree has the cull
(`contact_cells`), also as the package's main path calls them: cells are
elements (`[q=Q]`), and the hvp and hess on a list built once (`[list]`),
and the cull alone.

`--what k1k2`: K1 `shell_qp` modes 0 and 2 (value and gradient, adjoint)
and K2 `penalty_qp` modes 0, 1 and 2 (value and gradient, Hessian,
adjoint) through their public entry points (`kl_shell.shell_value_grad`,
`shell_adjoint`; `coupling.penalty_value_grad`, `penalty_hessians`,
`penalty_adjoint`) on the 20-patch wing, the num_el=32 plate (N = 7140)
and the pegasus-91 box wing (N = 11466), and K1 mode 3
(`kl_shell.shell_geom_grad`) on the MI T-beam (`tbeam.build_mi(num_el=40,
p=3, n_pts=17)`, N = 6072) and the num_el=16 tube, each at d = 1e-3 of its
CP scale on free dofs and lambda standard normal (seeded), back to back and
with the L2 flushed; the same calls on both trees.

`--what c6`: K1 mode 0 at the Scordelis-Lo roof's own equilibrium
(num_el=6, solved by the tree's package, plus chip_smoke.py's seeded
noise), against the tree's plain version and against the
cancellation-free evaluation of this checkout's
`kl_shell.shell_density_increments` (ROADMAP C6): the relative gaps in
norm, worst of (W, r, dW/dh). With `--state FILE` the noisy state is read
from FILE if it exists and written there if not, so that the kernels of
two trees are read at the same inputs.

`--what assemble`: K3 through `system.assemble_K_from` (K's zero-fill, the
launches of every group, the diagonal of fixed dofs) and as chip_smoke.py
times it (zeroed K, one launch per group) on the 20-patch wing (phase 3's
seeded state), the num_el=32 plate (N = 7140) and the pegasus-91 box wing
(N = 11466), each at d = 1e-3 of its CP scale on free dofs (seeded).

`--what k8k11`: K8 `pressure_qp` in its three modes (value and gradient,
Hessian, adjoint; `loads.pressure_value_grad`, `pressure_hessians`,
`pressure_adjoint`) on the num_el=16 tube's two stacks: the fixed-seam tube
(`tube.build(num_el=16, p=3, pressure=1e2)`, 27,744 qps, at chip_smoke.py's
`tube_state`) and the moving-seam tube (`draft_tube_shopt_mi_wffd.
build_mi_tube` at the same size, at d = 1e-3 of its CP scale on free dofs);
and K11 `vlm_aic` in both modes (`vlm.aic_value`, `aic_vjp`) on the full-
width 16 x 64 lattice of the 20-patch wing (N = 1024) and on the VLM demo's
6 x 10 (N = 60), at the deformed corners of chip_smoke.py's seeded d
(`vlm_cases`); the same calls on both trees.

`--what k5k7`: K7's Newton step and adjoint and K5 at the moving-
intersection paths' shapes: the MI T-beam (`tbeam.build_mi(num_el=40,
p=3, n_pts=17)`: one seam of 17 points, 4N = 68) and the num_el=16
moving-seam tube (four seams of 35 points, 4N = 140), at chip_smoke.py's
`mi_state` (xi moved 1e-3 off the seed, cp at the start) with a seeded g.
On every tree the composed step (`c2x_res_jac` with its Jacobian, batched
`torch.linalg.solve`, `c2x_res_jac` at x + dx, both norms; on a tree
whose mode 0 needs it, J's zero-fill) and the composed adjoint (mode 0,
the transposed solve, mode 1); on a tree with the fused modes, also
`c2x_step` and `c2x_solve_adjoint` (their dx and dcp against the composed
ones printed, not gated), and the host wall of a warm `c2x_newton` (from
the solution at cp, to cp moved by 1e-3 of the T-beam's bend; a readback
a step). K5 `traced_rows` at both sides' points of each path and at the
16 x 64 lattice's 1105 corners of the 20-patch wing.

`--what k6k9`: K6 `mi_penalty_xi` at the MI T-beam (`tbeam.build_mi(
num_el=40, p=3, n_pts=17)`, 1 x 17 points) and the num_el=16 moving-seam
tube (4 x 35) at chip_smoke.py's `mi_state`; K9 `vm_stress_qp` in both
modes (`kl_shell.vm_stress_value`, `vm_stress_vjp`) at the num_el=32 plate
(N = 7140) top and bottom, at chip_smoke.py's plate state (the Newton
solution plus seeded noise, a seeded gbar); the same calls on both trees.
Then K2's three modes at `chip_smoke.k2_bits`' input (the interface stack
unrolled so that no two qps share a node, so that K2's atomics cannot
reorder a sum) on the small wing and on wing20: their sha256, and with
`--k2-file FILE` the outputs themselves, written there if FILE does not
exist and compared by `torch.equal` if it does (run the parent first);
with `--k2-json FILE` the small wing's sha256 go to FILE as
tests/data/torch_port_k2_bits.json keeps them (`chip_smoke.phase_k2_bits`
and the `gpu` test of tests/test_torch_k6_k9.py hold K2 to them).

`--what k10`: K10 `pair_assemble` at pegasus-91 (the demo's box wing,
chip_smoke.py's seeded state of phase 13) through the tree's public entry
points, as the preconditioners run them: `assemble_blocks` into the patch
blocks (`patch_block_precond`'s) and into the pair blocks
(`PairSchwarz.assemble`'s; on a tree with stage 2, stage 1 + stage 2; on
a tree with the per-slot scatter, K's zero-fill, two launches and the
identity), each against the tree's plain version and bit for bit over 5
launches; with `--k10-file FILE` both block sets are written to FILE if it
does not exist and compared with it if it does (run the parent first;
110 MB, so keep FILE in a scratch directory). Then chip_smoke.py's GMRES
probe (`gmres_probe`: each preconditioner's set-up and GMRES seconds, its
restart cycles and |Kx + r|/|r|).

K12, K3, K8, K11, K5, K7, K6, K9 and K10 are timed back to back only: K12's
inputs are under 1 MB and K3 writes a K larger than the L2. Each number is the median of
`--repeats` measurements; each kernel is checked against its plain
version, and the ptxas registers and spill bytes of every redesigned
kernel's entry functions (those of the tree's K12 and K3 included) are
printed.

`--root` names the tree whose package is imported and built (default this
checkout), so that two commits can be compared in one chip call: unpack
the parent with `git archive <commit> | tar -x -C scratch_chip/parent` and
run parent, change, change, parent.

    python scripts/torch_port_kernel_ab.py [--root DIR] [--repeats 5]
        [--launches 20] [--what k1k4 contact assemble k1k2 c6 k8k11
        k5k7 k6k9 k10]
        [--state FILE] [--k2-file FILE] [--k2-json FILE] [--k10-file FILE]

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py (its timers, bound and ptxas parser),
    whatever tree `--root` imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runtime_shape_matvec(root, cuda):
    """K4's C entry `gf_jet_matvec` of tree `root` built with an empty
    table of compile-time shapes, and nvcc's output (with its ptxas
    summary); (None, "") where the tree's source has no replaceable
    table."""
    src = os.path.join(root, "goldfish_tpu_torch", "csrc", "jet_matvec.cu")
    with open(src) as fh:
        if "#ifndef GF_MATVEC_SHAPES" not in fh.read():
            return None, ""
    out = os.path.join(ROOT, "goldfish_tpu_torch", "_build",
                       "k4_runtime_shape")
    os.makedirs(out, exist_ok=True)
    stub = os.path.join(out, "jet_matvec_runtime_shape.cu")
    with open(stub, "w") as fh:
        fh.write(f'#define GF_MATVEC_SHAPES(X)\n#include "{src}"\n')
    so = os.path.join(out, "libjet_matvec_runtime_shape.so")
    cmd = [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-shared", "-o", so, stub]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n"
                           + (res.stdout + res.stderr)[-4000:])
    fn = ctypes.CDLL(so).gf_jet_matvec
    fn.argtypes = cuda._SIGNATURES["gf_jet_matvec"]
    fn.restype = ctypes.c_int
    return fn, res.stdout + res.stderr


def time_cases(sm, out, cases, launches, repeats, cold=True):
    import numpy as np

    for name, fn in cases.items():
        warm = [sm.cuda_ms(fn, launches) for _ in range(repeats)]
        out[name] = {"ms": float(np.median(warm)), "ms_all": warm}
        msg = f"back to back {out[name]['ms']:.4f} ms"
        if cold:
            c = [sm.cuda_ms_cold(fn, launches) for _ in range(repeats)]
            out[name].update(ms_cold=float(np.median(c)), ms_cold_all=c)
            msg += f", L2 flushed {out[name]['ms_cold']:.4f} ms"
        print(f"[ab] {name:44s} {msg}", flush=True)


def k1k4(sm, root, out, args):
    """K1's Hessian mode and K4 at wing20 (see the module's note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver import system

    dev = torch.device("cuda", 0)
    s = wing.build(num_el=6, p=3, device=dev)
    data, st = s.data, s.stack
    rng = np.random.default_rng(0)
    cp, h = s.cp, s.h_init
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * data.free
    rng.normal(size=tuple(cp.shape))   # phase 3's lambda
    v = T(rng.normal(size=tuple(cp.shape)))
    tab = system.jet_tables(data)
    Hs = system.jet_hessians(data, d, cp, h)
    free, vf = tab.free, v.reshape(-1)
    N = free.shape[0]
    groups = {"shell": (Hs[0], tab.R_e, tab.gi_e),
              "interface": (Hs[1], tab.R_i, tab.gi_i)}

    def matvec(fn):
        y = torch.zeros(N, dtype=torch.float64, device=dev)
        for H, R, gi in groups.values():
            fn(y, H, R, gi, free, vf)
        return y

    y_group = torch.zeros(N, dtype=torch.float64, device=dev)
    cases = {
        "shell_qp/hess": lambda: kl_shell.shell_hessians(
            st, d, cp, h, data.E, data.nu),
        "jet_matvec": lambda: matvec(system.jet_matvec),
        **{f"jet_matvec/{g}": (lambda grp=grp: system.jet_matvec(
            y_group, *grp, free, vf)) for g, grp in groups.items()},
    }
    err = out["rel_err"]
    err["shell_qp/hess"] = sm.rel_err(
        cases["shell_qp/hess"](),
        kl_shell._hessians_plain(st, d, cp, h, data.E, data.nu))[0]
    err["jet_matvec"] = sm.rel_err(matvec(system.jet_matvec),
                                   matvec(system._matvec_plain))[0]
    rt, rt_log = runtime_shape_matvec(root, _cuda)
    if rt is not None:
        for name, (regs, st_, ld, _) in sm.ptxas_spills(rt_log).items():
            print(f"[ptxas runtime-shape build] {name}: {regs} registers, "
                  f"spill stores {st_} B, spill loads {ld} B", flush=True)

        def matvec_rt(y, H, R, gi, free_, v_):
            G, nq, nj, nloc = R.shape
            p = _cuda.ptr
            rc = rt(p(H), p(R), p(gi), p(free_), p(v_), p(y), G, nq, nj,
                    nloc, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"runtime-shape K4: cudaError_t {rc}")
            return y

        cases["jet_matvec[runtime-shape]"] = lambda: matvec(matvec_rt)
        cases.update({f"jet_matvec[runtime-shape]/{g}": (
            lambda grp=grp: matvec_rt(y_group, *grp, free, vf))
            for g, grp in groups.items()})
        err["jet_matvec[runtime-shape]"] = sm.rel_err(
            matvec(matvec_rt), matvec(system._matvec_plain))[0]
    out["bytes"].update({
        "shell_qp/hess": sm.nbytes(d, cp, h, *st, *Hs[:1]),
        "jet_matvec": sm.nbytes(*[u for g in groups.values() for u in g],
                                free, vf, vf)})
    if rt is not None:
        out["bytes"]["jet_matvec[runtime-shape]"] = out["bytes"]["jet_matvec"]
    time_cases(sm, out, cases, args.launches, args.repeats)


def contact(sm, out, args):
    """K12 at press16 and press32 (see the module's note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.physics import contact as pc
    from goldfish_tpu_torch.solver import system
    from goldfish_tpu_torch.solver.implicit import continuation_solve

    dev = torch.device("cuda", 0)
    culls = hasattr(pc, "contact_cells")
    for num_el in (16, 32):
        tag = f"press{num_el}"
        s = sm.press_problem(num_el, dev)
        d, _, _ = continuation_solve(s.data, s.cp, s.h_init,
                                     s.zero_displacement(), n_steps=4,
                                     rtol=1e-9, max_it=40)
        rng = np.random.default_rng(20)   # chip_smoke.check_contact's
        d = d + 1e-3 * float(d.abs().max()) * torch.tensor(
            rng.normal(size=tuple(d.shape)), device=dev) * s.data.free
        c = s.data.contact
        x, w = (t.contiguous() for t in pc.contact_qps(s.stack, d, s.cp))
        v = torch.tensor(np.random.default_rng(20).normal(
            size=tuple(x.shape)), device=dev)
        tabs = system.jet_tables(s.data)
        Q = tabs.R_c.shape[1]
        N = tabs.free.shape[0]

        def hess(fn, **kw):
            K = torch.zeros(N, N, dtype=torch.float64, device=dev)
            return fn(K, c, x, w, tabs.R_c, tabs.gi_e, tabs.free, **kw), K

        cases = {
            f"contact_pairs/value_grad@{tag}":
                lambda: pc.contact_value_grad(c, x, w),
            f"contact_pairs/hvp@{tag}": lambda: pc.contact_hvp(c, x, w, v),
            f"contact_pairs/hess@{tag}": lambda: hess(pc.contact_hess),
        }
        if culls:
            cells = pc.contact_cells(c, x, w, Q)
            cases.update({
                f"contact_pairs/cull[q=Q]@{tag}":
                    lambda: pc.contact_cells(c, x, w, Q),
                f"contact_pairs/cull@{tag}":
                    lambda: pc.contact_cells(c, x, w),
                f"contact_pairs/value_grad[q=Q]@{tag}":
                    lambda: pc.contact_value_grad(c, x, w, q=Q),
                f"contact_pairs/hvp[q=Q]@{tag}":
                    lambda: pc.contact_hvp(c, x, w, v, q=Q),
                f"contact_pairs/hvp[list]@{tag}":
                    lambda: pc.contact_hvp(c, x, w, v, cells=cells),
                f"contact_pairs/hess[list]@{tag}":
                    lambda: hess(pc.contact_hess, cells=cells),
            })
        plain = {"value_grad": pc._value_grad_plain(c, x, w),
                 "hvp": pc._hvp_plain(c, x, w, v),
                 "hess": hess(pc._hess_plain)}
        for name, fn in cases.items():
            mode = name.split("/")[1].split("@")[0].split("[")[0]
            if mode == "cull":
                continue
            got = fn()
            out["rel_err"][name] = max(sm.rel_err(a, b)[0] for a, b in
                                       zip(got, plain[mode]))
        out["bytes"][f"contact@{tag}"] = sm.nbytes(x, w, v)
        time_cases(sm, out, cases, args.launches, args.repeats, cold=False)
        del s, plain
        torch.cuda.empty_cache()


def assemble(sm, out, args):
    """K3 at wing20, plate32 and pegasus-91 (see the module's note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.models import boxwing, plate, wing
    from goldfish_tpu_torch.solver import system

    dev = torch.device("cuda", 0)
    builds = {"wing20": lambda: wing.build(num_el=6, p=3, device=dev),
              "plate32": lambda: plate.build(num_el=32, p=2, num_patches=2,
                                             device=dev),
              "pegasus91": lambda: boxwing.build(**sm.PEG, device=dev)}
    for tag, build in builds.items():
        s = build()
        data, cp, h = s.data, s.cp, s.h_init
        rng = np.random.default_rng(0)
        scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
        d = torch.tensor(1e-3 * scale * rng.normal(size=tuple(cp.shape)),
                         device=dev) * data.free
        tab = system.jet_tables(data)
        Hs = system.jet_hessians(data, d, cp, h)
        N = tab.free.shape[0]
        groups = [(Hs[0], tab.R_e, tab.gi_e)]
        if Hs[1] is not None:
            groups.append((Hs[1], tab.R_i, tab.gi_i))

        def smoke_case(fn):
            K = torch.zeros(N, N, dtype=torch.float64, device=dev)
            for H, R, gi in groups:
                fn(K, H, R, gi, tab.free)
            return K

        cases = {f"assemble_K_from@{tag}":
                 lambda: system.assemble_K_from(tab, Hs),
                 f"jet_assemble[smoke case]@{tag}":
                 lambda: smoke_case(system.jet_assemble)}
        out["rel_err"][f"jet_assemble[smoke case]@{tag}"] = sm.rel_err(
            smoke_case(system.jet_assemble),
            smoke_case(system._assemble_plain))[0]
        out["bytes"][f"K@{tag}"] = N * N * 8
        time_cases(sm, out, cases, args.launches, args.repeats, cold=False)
        del s, Hs, tab
        torch.cuda.empty_cache()


def k1k2(sm, out, args):
    """K1 modes 0, 2, 3 and K2 modes 0, 1, 2 (see the module's note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.models import boxwing, plate, tbeam, tube, wing
    from goldfish_tpu_torch.physics import coupling, kl_shell

    dev = torch.device("cuda", 0)
    builds = {
        "wing20": lambda: wing.build(num_el=6, p=3, device=dev),
        "plate32": lambda: plate.build(num_el=32, p=2, num_patches=2,
                                       device=dev),
        "pegasus91": lambda: boxwing.build(**sm.PEG, device=dev),
        "mi_tbeam40": lambda: tbeam.build_mi(num_el=40, p=3, n_pts=17,
                                             device=dev),
        "tube16": lambda: tube.build(num_el=16, p=3, pressure=1e2,
                                     device=dev),
    }
    for tag, build in builds.items():
        s = build()
        data, cp, h = s.data, s.cp, s.h_init
        st, ifs, E, nu = data.stack, data.ifs, data.E, data.nu
        rng = np.random.default_rng(0)
        scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
        T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
        d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * data.free
        lam = T(rng.normal(size=tuple(cp.shape)))
        if tag in ("mi_tbeam40", "tube16"):
            pairs = {"shell_qp/geom_grad": (
                lambda: kl_shell.shell_geom_grad(st, d, cp, h, E, nu),
                lambda: kl_shell._geom_grad_plain(st, d, cp, h, E, nu))}
        else:
            pairs = {
                "shell_qp/value_grad": (
                    lambda: kl_shell.shell_value_grad(st, d, cp, h, E, nu),
                    lambda: kl_shell._value_grad_plain(st, d, cp, h, E,
                                                       nu)),
                "shell_qp/adjoint": (
                    lambda: kl_shell.shell_adjoint(st, d, cp, h, E, nu, lam),
                    lambda: kl_shell._adjoint_plain(st, d, cp, h, E, nu,
                                                    lam)),
                "penalty_qp/value_grad": (
                    lambda: coupling.penalty_value_grad(ifs, d, cp, h, E),
                    lambda: coupling._value_grad_plain(ifs, d, cp, h, E)),
                "penalty_qp/hess": (
                    lambda: coupling.penalty_hessians(ifs, d, cp, h, E),
                    lambda: coupling._hessians_plain(ifs, d, cp, h, E)),
                "penalty_qp/adjoint": (
                    lambda: coupling.penalty_adjoint(ifs, d, cp, h, E, lam),
                    lambda: coupling._adjoint_plain(ifs, d, cp, h, E, lam)),
            }
            out["shapes"][tag] = {"stack": list(st.R00.shape),
                                  "ifs": list(ifs.RA00.shape)}
        out["shapes"].setdefault(tag, {"stack": list(st.R00.shape)})
        cases = {}
        for name, (kern, plain) in pairs.items():
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            out["rel_err"][f"{name}@{tag}"] = max(
                sm.rel_err(a, b)[0] for a, b in zip(got, want))
            cases[f"{name}@{tag}"] = kern
        time_cases(sm, out, cases, args.launches, args.repeats)
        del s, data, st, ifs, cases, pairs
        torch.cuda.empty_cache()


def k8k11(sm, out, args):
    """K8 at tube16's two stacks, K11 at the VLM's two lattices (see the
    module's note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as mi_demo
    from goldfish_tpu_torch.demos import vlm_aeroelastic_wing as vlm_demo
    from goldfish_tpu_torch.models import tube

    dev = torch.device("cuda", 0)

    def run(tag, cases):
        timed = {}
        for name, (kern, plain, _, inputs, *_) in cases.items():
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            out["rel_err"][f"{name}@{tag}"] = max(
                sm.rel_err(a, b)[0] for a, b in zip(got, want))
            out["bytes"][f"{name}@{tag}"] = sm.nbytes(*inputs, *got)
            timed[f"{name}@{tag}"] = kern
        time_cases(sm, out, timed, args.launches, args.repeats, cold=False)

    s = tube.build(num_el=16, p=3, pressure=1e2, device=dev)
    cp, _, d, lam, _ = sm.tube_state(s)
    out["shapes"]["tube16"] = {"stack": list(s.stack.R00.shape)}
    run("tube16", sm.pressure_cases(s.data, d, cp, lam))
    del s, cp, d, lam
    s = mi_demo.build_mi_tube(num_el=16, p=3, pressure=1e2, device=dev)
    rng = np.random.default_rng(7)
    cp = s.cp
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    d = torch.tensor(1e-3 * scale * rng.normal(size=tuple(cp.shape)),
                     device=dev) * s.data.free
    lam = torch.tensor(rng.normal(size=tuple(cp.shape)),
                       device=dev) * s.data.free
    out["shapes"]["tube16_mi"] = {"stack": list(s.stack.R00.shape)}
    run("tube16_mi", sm.pressure_cases(s.data, d, cp, lam))
    del s, cp, d, lam
    torch.cuda.empty_cache()
    for tag, kw in (("wing20", sm.VLM_WIDE), ("demo", sm.VLM_DEMO)):
        J_of_h, s, _ = vlm_demo.build_coupled(**kw, device=dev)
        rng = np.random.default_rng(12)   # chip_smoke.phase_vlm_kernels'
        cp = s.cp
        scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
        d = torch.tensor(1e-3 * scale * rng.normal(size=tuple(cp.shape)),
                         device=dev) * s.data.free
        corners = J_of_h.corners(d)
        out["shapes"][f"vlm_{tag}"] = {"lattice": list(corners.shape[:2])}
        run(f"vlm_{tag}", sm.vlm_cases(corners, 12))
        del J_of_h, s
        torch.cuda.empty_cache()


def k5k7(sm, out, args):
    """K7's step and adjoint, composed and fused, and K5 (see the module's
    note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as mi_demo
    from goldfish_tpu_torch.geometry import cpiga2xi
    from goldfish_tpu_torch.models import tbeam, wing
    from goldfish_tpu_torch.ops import bspline_traced as bt
    from goldfish_tpu_torch.physics import vlm

    dev = torch.device("cuda", 0)
    fused = hasattr(cpiga2xi, "c2x_step")

    def step_composed(ss, p, q, mi, cp, x):
        r, J = cpiga2xi.c2x_res_jac(ss, p, q, mi, cp, x)
        x_new = x + torch.linalg.solve(J, -r[..., None])[..., 0]
        r_new, _ = cpiga2xi.c2x_res_jac(ss, p, q, mi, cp, x_new, jac=False)
        return x_new, torch.stack([torch.linalg.norm(r, dim=-1),
                                   torch.linalg.norm(r_new, dim=-1)], -1)

    def adjoint_composed(ss, p, q, mi, cp, x, g):
        _, J = cpiga2xi.c2x_res_jac(ss, p, q, mi, cp, x)
        lam = torch.linalg.solve(J.transpose(-1, -2), g[..., None])[..., 0]
        return cpiga2xi.c2x_res_vjp(ss, p, q, mi, cp, x, lam.contiguous())

    def rows(tag, ss, p, q, ip, pts):
        conn, R = bt.traced_rows(ss, p, q, ip, pts)
        conn_p, R_p = bt._rows_plain(ss, p, q, ip, pts)
        if not torch.equal(conn, conn_p):
            raise RuntimeError(f"traced_rows@{tag}: conn differs")
        out["rel_err"][f"traced_rows@{tag}"] = sm.rel_err(R, R_p)[0]
        out["bytes"][f"traced_rows@{tag}"] = sm.nbytes(ip, pts, conn, R)
        return {f"traced_rows@{tag}": lambda: bt.traced_rows(ss, p, q, ip,
                                                             pts)}

    builds = (("mi_tbeam40", lambda: tbeam.build_mi(num_el=40, p=3,
                                                    n_pts=17, device=dev)),
              ("tube16_mi", lambda: mi_demo.build_mi_tube(
                  num_el=16, p=3, pressure=1e2, device=dev)))
    for tag, build in builds:
        s = build()
        cp, _, xi, _, _ = sm.mi_state(s)
        ss, p, q, mi = s.ss, s.pdeg, s.qdeg, s.mi
        I, N = mi.n_int, mi.n_max
        g = torch.tensor(np.random.default_rng(2).normal(size=(I, 4 * N)),
                         device=dev)
        args_x = (ss, p, q, mi, cp, xi)
        cases = {f"xi step composed@{tag}": lambda: step_composed(*args_x),
                 f"xi adjoint composed@{tag}":
                     lambda: adjoint_composed(*args_x, g)}
        if fused:
            cases[f"xi step fused@{tag}"] = \
                lambda: cpiga2xi.c2x_step(*args_x)
            cases[f"xi adjoint fused@{tag}"] = \
                lambda: cpiga2xi.c2x_solve_adjoint(*args_x, g)
            xc, nc = step_composed(*args_x)
            xf, nf = cpiga2xi.c2x_step(*args_x)
            out["k7_vs_composed"][f"dx@{tag}"] = sm.rel_err(xf - xi,
                                                            xc - xi)[0]
            out["k7_vs_composed"][f"norm0@{tag}"] = sm.rel_err(
                nf[:, 0], nc[:, 0])[0]
            out["k7_vs_composed"][f"dcp@{tag}"] = sm.rel_err(
                cpiga2xi.c2x_solve_adjoint(*args_x, g),
                adjoint_composed(*args_x, g))[0]
        x4 = xi.reshape(I, N, 2, 2)
        ip = torch.cat([mi.pairA[:, None].expand(I, N).reshape(-1),
                        mi.pairB[:, None].expand(I, N).reshape(-1)])
        pts = x4.permute(2, 0, 1, 3).reshape(-1, 2).contiguous()
        cases.update(rows(tag, ss, p, q, ip.contiguous(), pts))
        out["shapes"][tag] = {"seams": [I, N], "points": int(ip.numel())}
        time_cases(sm, out, cases, args.launches, args.repeats, cold=False)
        # the host wall of a warm xi solve: the solution at cp, then cp
        # moved by 1e-3 of the T-beam's design direction (the tube: of
        # its own scale), a readback a Newton step
        c2x = s.c2x
        x0, _, _ = cpiga2xi.c2x_newton(ss, p, q, mi, cp, xi.clone())
        dcp = 1e-3 * 0.05 * torch.tensor(np.random.default_rng(9).normal(
            size=tuple(cp.shape)), device=dev)
        walls, its = [], []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, it, _ = cpiga2xi.c2x_newton(ss, p, q, mi, cp + dcp,
                                           x0.clone(), rtol=c2x.rtol)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            its.append(it)
        out["xi_newton_wall"][tag] = {"s": float(np.median(walls)),
                                      "all": walls, "its": its}
        print(f"[ab] xi newton warm wall@{tag} {np.median(walls) * 1e3:.3f}"
              f" ms, its {its}", flush=True)
        del s, c2x
        torch.cuda.empty_cache()
    s = wing.build(n_chord=4, n_span=5, num_el=6, p=3, device=dev)
    ss, (p, q) = bt.make_surf_set(s.surfs, device=dev)
    lat = vlm.build_lattice_param(4, 5, 16, 64, device=dev)
    time_cases(sm, out, rows("vlm_wing20", ss, p, q,
                             lat.ip.reshape(-1).contiguous(),
                             lat.xi.reshape(-1, 2).contiguous()),
               args.launches, args.repeats, cold=False)
    for k, v in out["k7_vs_composed"].items():
        print(f"[ab] fused vs composed {k}: rel {v:.3e}", flush=True)


def k6k9(sm, out, args):
    """K6 at the two moving-seam paths, K9 at plate32, K2's bits (see the
    module's note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as mi_demo
    from goldfish_tpu_torch.models import plate, tbeam
    from goldfish_tpu_torch.physics import coupling_mi

    dev = torch.device("cuda", 0)
    timed = {}
    for tag, build in (
            ("mi_tbeam40", lambda: tbeam.build_mi(num_el=40, p=3, n_pts=17,
                                                  device=dev)),
            ("tube16_mi", lambda: mi_demo.build_mi_tube(
                num_el=16, p=3, pressure=1e2, device=dev))):
        s = build()
        cp, h, xi, d, lam = sm.mi_state(s)
        mi = s.mi
        x4 = xi.reshape(mi.n_int, mi.n_max, 2, 2).contiguous()
        tA = coupling_mi._curve_tangents(x4[:, :, 0], mi.n_pts).contiguous()
        tB = coupling_mi._curve_tangents(x4[:, :, 1], mi.n_pts).contiguous()
        a = (s.ss, s.pdeg, s.qdeg, mi, s.co, x4, tA, tB, d, cp, h,
             s.data.E, lam)
        name = f"mi_penalty_xi@{tag}"
        out["rel_err"][name] = sm.rel_err(coupling_mi.mi_penalty_xi(*a),
                                          coupling_mi._xi_grad_plain(*a))[0]
        timed[name] = lambda a=a: coupling_mi.mi_penalty_xi(*a)
        out["shapes"][tag] = {"seams": [mi.n_int, mi.n_max]}
    time_cases(sm, out, timed, args.launches, args.repeats, cold=False)
    del timed
    torch.cuda.empty_cache()
    s = plate.build(num_el=32, p=2, num_patches=2, device=dev)
    rng = np.random.default_rng(8)   # chip_smoke.phase_plate_kernels'
    T = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    d = s.solve_nonlinear(rtol=1e-10)
    dn = d + T(1e-3 * float(d.abs().max())
               * rng.normal(size=tuple(s.cp.shape))) * s.data.free
    gbar = T(rng.normal(size=tuple(s.stack.wq.shape)))
    out["shapes"]["plate32"] = {"stack": list(s.stack.R00.shape)}
    timed = {}
    for th in ("top", "bottom"):
        cases = sm.stress_cases(s.stack, s.E, s.nu, dn, s.cp, s.h_init, gbar,
                                th)
        for name, (kern, plain, _, inputs, *_) in cases.items():
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            key = f"{name}@plate32_{th}"
            out["rel_err"][key] = max(sm.rel_err(x, y)[0]
                                      for x, y in zip(got, want))
            out["bytes"][key] = sm.nbytes(*inputs, *got)
            timed[key] = kern
    time_cases(sm, out, timed, args.launches, args.repeats, cold=False)
    del s, timed
    torch.cuda.empty_cache()
    saved, same = {}, {}
    for tag, kw in (("wing_small", {}), ("wing20", dict(num_el=6, p=3))):
        got = sm.k2_bits(dev, **kw)
        out["k2_sha256"][tag] = {k: sm.sha256(v) for k, v in got.items()}
        saved[tag] = {k: v.cpu() for k, v in got.items()}
    if args.k2_file and os.path.exists(args.k2_file):
        ref = torch.load(args.k2_file)
        for tag, outs in saved.items():
            for k, v in outs.items():
                same[f"{tag} {k}"] = bool(torch.equal(v, ref[tag][k]))
                print(f"[ab] K2 {tag} {k:20s} torch.equal to {args.k2_file}"
                      f" {same[f'{tag} {k}']}", flush=True)
        out["k2_equal"] = same
    elif args.k2_file:
        torch.save(saved, args.k2_file)
        print(f"[ab] K2 outputs written to {args.k2_file}", flush=True)
    for tag, h in out["k2_sha256"].items():
        print(f"[ab] K2 {tag} sha256 {json.dumps(h)}", flush=True)
    if args.k2_json:
        with open(args.k2_json, "w") as fh:
            json.dump({"sha256": out["k2_sha256"]["wing_small"],
                       "input": "chip_smoke.k2_bits(dev): the small wing",
                       "card": out["card"],
                       "tree": os.path.relpath(out["root"], ROOT)}, fh,
                      indent=1)


def k10(sm, out, args):
    """K10 at pegasus-91 through the tree's public entry points (see the
    module's note), then chip_smoke.py's GMRES probe of the three
    preconditioners."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.demos import pegasus_thickness_opt as demo
    from goldfish_tpu_torch.solver import krylov, system

    dev = torch.device("cuda", 0)
    ns = demo.setup(**sm.PEG, route="krylov", device=dev)
    s = ns.sys
    data, cp, h = s.data, s.cp, s.h_init
    rng = np.random.default_rng(9)   # chip_smoke.phase_pegasus_kernels'
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    d = torch.tensor(1e-3 * scale * rng.normal(size=tuple(cp.shape)),
                     device=dev) * data.free
    ps = krylov.PairSchwarz(data)
    tab = ps.tables
    Hs = system.jet_hessians(data, d, cp, h)
    P, n = data.stack.n_patches, 3 * data.stack.max_cp
    if hasattr(krylov, "patch_assemble"):   # patch blocks, then pairs
        patches = krylov._block_tables(data)
        run = {"patches": lambda: krylov.assemble_blocks(patches, tab, Hs),
               "pairs": lambda: krylov.assemble_blocks(ps.blocks, tab, Hs)}

        def plain(name):
            Kp = torch.empty(P, n, n, dtype=torch.float64, device=dev)
            bt = patches if name == "patches" else ps.blocks
            krylov._patch_assemble_plain(Kp, bt, tab, Hs)
            if name == "patches":
                return Kp
            X = torch.empty(ps.I, 2 * n, 2 * n, dtype=torch.float64,
                            device=dev)
            krylov._pair_assemble_plain(X, Kp, bt, tab, Hs)
            return X
    else:                                   # the per-slot scatter
        patches = krylov._block_tables(data, krylov._patch_blocks_of(P), P,
                                       n)
        run = {k: (lambda k=k, bt=bt: krylov.assemble_blocks(
            bt, tab, Hs, f"pair_assemble/{k}"))
            for k, bt in (("patches", patches), ("pairs", ps.blocks))}

        def plain(name):
            bt = patches if name == "patches" else ps.blocks
            K = torch.zeros(bt.n_blocks, bt.nb, bt.nb, dtype=torch.float64,
                            device=dev)
            for H, R, t in ((Hs[0], tab.R_e, bt.elem),
                            (Hs[1], tab.R_i, bt.iface)):
                krylov._pair_assemble_plain(K, H, R, t)
            K.diagonal(dim1=1, dim2=2).add_(1.0 - bt.free)
            return K
    saved, timed = {}, {}
    for name, fn in run.items():
        key = f"pair_assemble/{name}@pegasus91"
        got = fn()
        out["rel_err"][key] = sm.rel_err(got, plain(name))[0]
        same = all(torch.equal(fn(), got) for _ in range(4))
        out.setdefault("k10_bitwise", {})[key] = same
        print(f"[ab] {key:44s} bit-identical over 5 launches {same}",
              flush=True)
        saved[name] = got
        timed[key] = fn
    time_cases(sm, out, timed, args.launches, args.repeats, cold=False)
    if args.k10_file and os.path.exists(args.k10_file):
        ref = torch.load(args.k10_file)
        for name, got in saved.items():
            r = ref[name].to(dev)
            gap = sm.rel_err(got, r)
            out.setdefault("k10_vs_file", {})[name] = list(gap)
            print(f"[ab] K10 {name} against {args.k10_file}: rel "
                  f"{gap[0]:.3e} max abs {gap[1]:.3e}", flush=True)
    elif args.k10_file:
        torch.save({k: v.cpu() for k, v in saved.items()}, args.k10_file)
        print(f"[ab] K10 blocks written to {args.k10_file}", flush=True)
    del saved, timed
    torch.cuda.empty_cache()
    sm.gmres_probe(ns, dev)


def c6(sm, out, args):
    """K1 mode 0 at the roof three ways (see the module's note)."""
    import numpy as np
    import torch

    from goldfish_tpu_torch.models import slr
    from goldfish_tpu_torch.physics import kl_shell

    spec = importlib.util.spec_from_file_location(
        "kl_shell_here", os.path.join(ROOT, "goldfish_tpu_torch", "physics",
                                      "kl_shell.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    dev = torch.device("cuda", 0)
    _, d, s = slr.solve_qoi(num_el=6, load_scale=1e-3, device=dev)
    rng = np.random.default_rng(23)   # chip_smoke.path_kernels' draws
    for _ in range(3):                # its state, lambda and v
        rng.normal(size=tuple(d.shape))
    free, cp, h = s.data.free, s.cp, s.h_init
    de = d + torch.tensor(1e-3 * float(d.abs().max())
                          * rng.normal(size=tuple(d.shape)),
                          device=dev) * free
    if args.state and os.path.exists(args.state):
        de = torch.load(args.state).to(dev)
    elif args.state:
        torch.save(de.cpu(), args.state)
    st, E, nu = s.stack, s.data.E, s.data.nu
    got = {"kernel": kl_shell.shell_value_grad(st, de, cp, h, E, nu),
           "plain": kl_shell._value_grad_plain(st, de, cp, h, E, nu),
           "cancellation-free": here._value_grad_plain(
               st, de, cp, h, E, nu,
               density=here.shell_density_increments)}
    names = list(got)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            gap = max(sm.rel_err(x, y)[0] for x, y in zip(got[a], got[b]))
            out["c6"][f"{a} vs {b}"] = gap
            print(f"[c6] {a} vs {b}: {gap:.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--state", default=None)
    ap.add_argument("--k2-file", default=None)
    ap.add_argument("--k2-json", default=None)
    ap.add_argument("--k10-file", default=None)
    ap.add_argument("--what", nargs="*", default=["k1k4", "contact",
                                                  "assemble", "k1k2"],
                    choices=["k1k4", "contact", "assemble", "k1k2", "c6",
                             "k8k11", "k5k7", "k6k9", "k10"])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs one GPU")
    sm = _smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from goldfish_tpu_torch import _cuda

    if not os.path.abspath(_cuda.__file__).startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    with open(_cuda.build_info["ptxas_log"]) as fh:
        names = sm.REDESIGNED + ("pair_tile_kernel",)
        spills = {k: v for k, v in sm.ptxas_spills(fh.read()).items()
                  if any(n in k for n in names)}
    for name, (regs, st, ld, frame) in spills.items():
        print(f"[ptxas] {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B, stack frame {frame} B", flush=True)
    out = {"card": card, "root": root, "build_s": build_s,
           "ptxas": {k: list(v) for k, v in spills.items()},
           "rel_err": {}, "bytes": {}, "shapes": {}, "c6": {},
           "k7_vs_composed": {}, "xi_newton_wall": {}, "k2_sha256": {}}
    if "k1k4" in args.what:
        k1k4(sm, root, out, args)
    if "contact" in args.what:
        contact(sm, out, args)
    if "assemble" in args.what:
        assemble(sm, out, args)
    if "k1k2" in args.what:
        k1k2(sm, out, args)
    if "c6" in args.what:
        c6(sm, out, args)
    if "k8k11" in args.what:
        k8k11(sm, out, args)
    if "k5k7" in args.what:
        k5k7(sm, out, args)
    if "k6k9" in args.what:
        k6k9(sm, out, args)
    if "k10" in args.what:
        k10(sm, out, args)
    for name, b in out["bytes"].items():
        print(f"[ab] {name:44s} bytes {b / 1e6:.1f} MB, byte bound "
              f"{b / sm.PEAK_BYTES * 1e3:.4f} ms", flush=True)
    for name, e in out["rel_err"].items():
        print(f"[ab] {name:44s} rel err vs plain {e:.2e}", flush=True)
        if not e <= sm.KERNEL_TOL:
            raise RuntimeError(f"{name}: kernel vs plain {e:.3e}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
