"""GPU smoke run of the PyTorch port's main paths (one NVIDIA card).

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no result line):

1. device: a CUDA card must be present; prints its name and power limit
   (nvidia-smi) and turns TF32 off;
2. build: nvcc-compiles goldfish_tpu_torch/csrc/*.cu into
   goldfish_tpu_torch/_build/ (first use) and prints the ptxas summary,
   then the registers, spill and stack bytes of the redesigned kernels:
   K1's four modes, K2's three, every K4 instantiation, K12's cull and
   work kernels, every K3 instantiation, K8's three, K11's two, K5 and
   K7's four modes and its cross-intersection sum, K6, K9's value, VJP,
   gather and rows kernels, K13's three and K14's three (it fails if any of
   K1, K2, K12, K3, K8, K11, K5, K7, K6, K9, K10, K13 or K14 spills, or K5,
   K7 or K6 has a stack frame); then K2's
   three modes on the small wing's interface stack unrolled so that no two
   qps share a node (no two atomics meet) against the outputs the parent
   tree's K2 gave on the card, bit for bit (`[kernel K2 bits]`, sha256 in
   tests/data/torch_port_k2_bits.json: the extended penalty_sweep.cuh
   must leave K2 as it was), and K13's outputs at seeded inputs against
   the parent tree's, bit for bit (`[kernel K13 bits]`,
   tests/data/torch_port_k13_bits.json: the pieces moved into
   csrc/chol_blocks.cuh for K14 must leave K13 as it was);
3. wing kernels: at the full 20-patch wing (6600 dofs) on the card, at a
   seeded nonzero d, K1 shell_qp and K2 penalty_qp in their three modes
   and their forward design-tangent modes (K1 mode 4, K2 mode 3, along a
   seeded (tcp, th); so wherever K1-K4 are checked below),
   K3 jet_assemble and K4 jet_matvec against their plain PyTorch versions
   (relative error in norm <= 1e-11; f64 atomics sum in a run-dependent
   order), with both times; K4 also timed with the L2 flushed before each
   launch (`ms_cold`: in a solver loop its 48.8 MB of jets come from device
   memory), K1 and K2 with the bounds of their own algorithms (K1's
   structured Hessian; the reverse sweeps of K1's other modes and of K2)
   and, beside them, the yardstick of the dual-number kernels they
   replaced (`bound_ms_15col`, `bound_ms_dual`); then, printed and not
   gated, how much K1's and K2's mode a outputs change over 5 launches on
   one input (`[kernel C2]`: f64 atomics, ROADMAP C2);
4. wing main path: one thickness-optimization iteration of bench.py's
   workload (cold, with the adjoint gradient), checked against the JAX
   package's CPU f64 numbers in tests/data/torch_port_wing20_reference.json
   (J 1e-8, dJ/dh_ffd 1e-6), then 5 warm 1e-4 steps with the secant warm
   start and one 1e-2 refactor step;
5. MI kernels: the moving-intersection T-beam of scripts/bench_mi.py at its
   full size (N = 6072 dofs, one seam of 17 points) on the card, at a
   seeded state (xi moved within its knot spans, d the linear response to
   the tip load, lambda random): K5 traced_rows (also at the unperturbed
   seam that lies on a knot; conn equal, R 1e-13), K6 mi_penalty_xi (also
   at the unperturbed seam on the knot; then over 5 launches on one input
   bit for bit, `[kernel C2] mi_penalty_xi`), K6 mode 1 (the xi-forward
   tangent of the penalty residual), K7 mode 4 (the cp-forward tangent of
   its residual, also at the edge seam), K7
   c2x_res_jac in its four modes (residual and Jacobian, the given-lambda
   adjoint, the fused Newton step: dx 1e-10, |r(x)| and |r(x + dx)|
   1e-12 of |r(x)|, and the fused adjoint: dcp 1e-12, each beside the
   composed route it replaces, `ms_composed`; also at a seam along an
   edge of both patches, whose coincidence rows take the edge-to-edge
   variant), then K7's adjoint modes over 5 launches on one input, which
   must give dcp bit for bit (`[kernel C2] c2x adjoint`), K1's
   geometry-gradient mode, and
   K1-K4 as the MI path runs them (d with seeded noise, as for the wing:
   at the coupled response the seam's displacement jump cancels, and K2
   mode a there is printed beside its own one-ulp sensitivity, not
   gated): K1 and K2 in their three modes on the T-beam stack and on the
   interface stack of K5's rows, K3 for the full MI tangent and through
   the Woodbury seam-slot map, K4 - each against its plain version
   (1e-11), with both times;
6. MI main path: one shape iteration of bench_mi.py (cp(amp) -> xi ->
   warm-started MI Newton with the Woodbury seam correction -> J -> dJ/damp
   through both implicit solves), cold at amp = 0.05 from d = 0, checked
   against tests/data/torch_port_mi_tbeam40_reference.json (J 1e-8,
   dJ/damp 1e-6), then 5 warm steps amp = 0.05 (1 + 1e-3 k) with secant
   warm starts for d, xi and (inside the solve) the adjoint, and the xi
   solve's route (fused: K7 modes 2 and 3 must have run) with K7's
   launches by mode (the tube's moving-seam path prints the same); then,
   outside the counted path, the system's own `solve_nonlinear` at amp = 0.05
   against `build_forward`'s coupled solve (1e-8: ROADMAP Queue C1);
6b. OM MI path: the same T-beam through the OpenMDAO graph of
   goldfish_tpu_torch/demos/om_tbeam_shopt_mi.py (`build_problem(num_el=40,
   p=3, n_pts=17)`, its default design: 18 design CPs of the x field ->
   CPIGA2XiComp -> DispMintStatesComp -> IntEnergyComp, with the xi-edge
   and pin constraints): the cold `run_model` and `compute_totals` of w_int
   w.r.t. the design CPs against tests/data/torch_port_om_mi_reference.json
   (w_int 1e-8, xi 1e-10 in norm, the totals 1e-6); K1's four modes, K2's
   three, K3, K4, K5, K6 and K7's modes 0, 1 and 2 must have launched on it
   (printed by K7 mode); then `run_driver` (SLSQP, maxiter 6), which must
   end where the JAX demo's does: SLSQP stops at its first iteration
   (ROADMAP C9: the demo's bounds clip its pinned start, and its 17 xi-edge
   rows and 2 pin rows outnumber the 18 design variables), w_int lower
   (1e-8 against the reference's end value), the xi-edge residual <= 1e-6
   and the pin residual the reference's (the clip, 0.05); its walls per fun
   and jac evaluation, nfev/njev, the factorizations and the xi route are
   printed, not gated;
6e. the forward design tangents: the three implicit operations'
   apply_linear_fwd (CPIGA2Xi in (cp, xi), the displacement in (cp, h, xi,
   d)) at the small OM MI T-beam (num_el=3, p=2, 7 points) against the JAX
   operations' stored products (tests/data/torch_port_om_mi_reference.json
   `fwd_*`, 1e-10); then the counted path, check_partials of phase 6b's
   num_el=40 graph at step 1e-7 (explicit components past FD_COLUMNS_MAX
   input entries left out: w_int's and the CP embedding's), held to
   tests/test_torch_om_mi.py's bar (rel < 1e-4, at least 10 blocks); K1
   mode 4, K2 mode 3, K6 mode 1 and K7 mode 4 must have launched on it;
6c. eVTOL MI path: the wing box with moving spar and rib seams of
   goldfish_tpu_torch/demos/evtol_wing_shopt_mi.py at the demo's own size
   (`build_problem(num_el=4, p=3)`, variant rspar_rrib: 3 design dofs,
   four seams of 11 points): K5-K7 and K1-K4 at its shapes against their
   plain versions (1e-11; `phase_mi_kernels`), then the counted path: the
   cold `run_model` and `compute_totals` against
   tests/data/torch_port_om_mi_5b_reference.json (w_int 1e-8, xi 1e-10 in
   norm, totals 1e-6), K1's four modes, K2's three, K3, K4, K5, K6 and K7's
   modes 0, 1 and 2 launched on it; then `run_driver` (SLSQP, maxiter 6):
   w_int lower by more than 25%, the spar moved by more than 0.05, the
   design within 1e-4 of the JAX run's, the xi-edge invariant within
   1e-8; its walls per fun and jac, nit/nfev/njev beside JAX's and the
   factorizations are printed;
6d. the 4-patch moving-seam tube with multi-block FFD through the OpenMDAO
   graph of goldfish_tpu_torch/demos/tube_shopt_mi_4patch_wffd.py at the
   tube phases' size and pressure (num_el=16, p=3, 1e2 Pa; its kernels
   are checked at these shapes in phase 7): the cold `run_model` and
   totals of int_E w.r.t. both design fields against the same file (J
   1e-8, xi 1e-10, totals 1e-6), the OM MI kernels and K8's three modes
   launched; then `run_driver` (SLSQP, maxiter 3): J lower and within 1e-6
   of the JAX run's end, the designs within 1e-4, every free xi in (0, 1);
7. tube kernels: the pressurized tube at the size and follower pressure of
   tests/data/torch_port_tube16_reference.json (num_el=16, p=3: 4 patches,
   degree (3, 2), 12 qps, N = 8436) on the card, at d = the pressure's linear
   response plus seeded noise, lambda random: K8 pressure_qp in its three
   modes and K1-K4 (K3/K4 with the pressure group) on the fixed-seam
   elliptic tube, then, printed and not gated, how much K8's mode 0
   outputs change over 5 launches on one input (`[tube-kernel C2]`); the
   follower pressure's forward design product (K8 mode c at lambda = tcp)
   against the plain jvp of its residual, and the tube's whole forward
   product (`residual_jvp`, counted: K1 mode 4, K2 mode 3 and K8 mode c
   launched, `[design-tube]`); K8 in
   its three modes (at d = seeded noise) and K5-K7 and K1-K4 (K3 also
   through the seam-slot map) on the moving-seam tube (four edge seams of
   35 points, xi moved inside its edges); each against its plain version
   (1e-11), with both times;
8. fixed-seam tube path (goldfish_tpu_torch/demos/tube_shape_opt.py): J
   and dJ/dp at p0 from d = 0 against tests/data/
   torch_port_tube16_reference.json (J 1e-8, gradient 1e-6), then
   OptProblem.run_slsqp(maxiter=3): it must lower J and keep the pin
   residual <= 1e-10;
9. moving-seam tube path (goldfish_tpu_torch/demos/
   draft_tube_shopt_mi_wffd.py): the same at p_start;
10. plate kernels: the stress-constrained plate of tests/data/
   torch_port_plate32_reference.json (num_el=32, p=2: 2 patches, C = 1190,
   N = 7140, 9 qps, the first L = 9 model on the card) at d = its Newton
   solution plus seeded noise: K9 vm_stress_qp in its three modes (top
   and bottom; value 1e-12, VJP 1e-11, rows 1e-12) and K1-K4 (1e-11)
   against their plain versions, with both times; the smallest stress of
   a real qp at the solution (K9 and its plain version give no derivative
   at sigma = 0); K9's VJP over 5 launches on one input must give dd, dcp
   and dh bit for bit (`[kernel C2] vm vjp`: no atomics), and so must its
   rows, which summed against the cotangent must give the VJP (1e-13 of
   the summands' magnitude);
11. plate path (goldfish_tpu_torch/demos/plate_var_th_opt_stress.py through
   the port's OpenMDAO graph and om_shim): the cold run_model (KS stress at
   rho = 100 and volume, 1e-8 against the reference), compute_totals of
   the volume and of the KS stress at rho = 50/m w.r.t. the thickness FFD
   (1e-6), then the demo's SLSQP (run_driver, maxiter 30): it must lower
   the volume and meet each of the demo's assertions that the JAX
   reference meets at this size; then, counted apart, check_partials of
   the graph at its end state (step 1e-7; tests/test_om_adapters.py's
   bars: rel < 5e-5, zero blocks abs < 1e-8; the volume, KS stress and
   FE-to-IGA components, past FD_COLUMNS_MAX columns, left out), which
   must launch K1 mode 4 and K2 mode 3; then the sibling demo
   (om_plate_var_th_opt_wint.py) at the same size: cold run_model and
   totals against the reference's sibling numbers;
12. library calls: cholesky_ex, the Woodbury capacitance linalg.solve and
   the batched xi linalg.solve at each path's size, timed with CUDA events
   beside their bounds; at the same equilibrated K, K14 (`phase_k14`,
   `[k14 <path>]` lines, at wing20, the MI T-beam, both tubes, plate32,
   pegasus-91 and press32) against cholesky_ex: the factor's backward
   error ||K - L L^T|| / ||K|| within 4x cholesky_ex's, the same bits over
   two launches, `info` equal (also with one diagonal entry negated), at
   a well-conditioned SPD matrix of the same N L within 1e-12 of
   cholesky_ex's, K14's diagonal inverses against `diag_inverses` of its
   factor (backward error within 4x), its times with the L2 flushed beside
   the plain version's, cholesky_ex's and the bound, and the peak memory
   of one factorization beside cholesky_ex's; then, on K14's factor and
   inverses, K13
   (`phase_k13`, `[k13 <path>]` lines): K13 chol_subst's inverses of
   the diagonal blocks and its one-column substitution at three seeded
   right-hand sides, at an MI factor also its M-column substitution of
   the Woodbury basis K^-1 U^T, each against its plain version: the
   backward error of the equilibrated system ||K x - b|| / (||K|| ||x||)
   within 4x the plain version's (a direct x-to-x bar would be as loose
   as cond(L) allows), the same bits over two launches, and at a
   well-conditioned SPD matrix of the same N the kernel within 1e-12 of
   the plain version; its times with the L2 flushed beside the plain
   version's, cholesky_solve's (its copy of the factor included), the
   solve_triangular pair's (the library route without the copy) and the
   bound;
13. pegasus kernels: the full box wing of goldfish_tpu_torch/demos/
   pegasus_thickness_opt.py (91 patches, 216 interfaces, C = 42, N =
   11466, L = 16) at a seeded d: K10 pair_assemble into the (91, 126, 126)
   patch blocks (stage 1) and the (216, 252, 252) pair blocks (stages 1 +
   2), each bit for bit over 5 launches, and K1-K4, each against its plain
   version (1e-11; K10 1e-13), with both times;
14. pegasus dense route (the persistent Cholesky factor): cold W_int and
   dW_int/dh_ffd at the start from d = 0 against tests/data/
   torch_port_pegasus91_reference.json (J 1e-8, gradient 1e-6), then 3 warm
   1e-4 steps;
15. pegasus Newton-Krylov route (the demo's `route="krylov"`: GMRES-IR
   forward and adjoint): first a probe, counted apart from the main path
   (K10's only launches: no main path converges with its preconditioners),
   one GMRES-IR pass on the cold Newton system with each preconditioner
   (pair-Schwarz and patch blocks through K10, capped at 4 restart cycles;
   the dense f64 LU), printed with its residual; then the main path, the
   demo on the dense-LU preconditioner: cold W_int and gradient against
   the same reference (J 1e-10, gradient 1e-5: 100x the first run's worst,
   4.3e-13 and 9.7e-8, rounded up), the same for the per-patch thickness
   variant, then run_slsqp(maxiter=3): it must lower W_int and hold the
   volume to 1e-9; then the batched pair LU, its solves, the dense LU and
   its solve, timed beside their bounds;
16. VLM demo path (goldfish_tpu_torch/demos/vlm_aeroelastic_wing.py's
   `main` at its defaults: 2 x 3 patches, num_el=3, 6 x 10 panels, 4
   fixed-point passes): W_int and lift (1e-8), tip displacement and
   dW_int/dh (1e-6) against tests/data/torch_port_vlm_reference.json, and
   the demo's central-difference check (< 1e-5);
17. VLM at full width (the benchmark wing under the 16 x 64 lattice): its
   build (`build_coupled` computes the lattice's K5 rows once), the
   cold coupled evaluation with its gradient against the same file (J,
   lift 1e-8, tip, gradient 1e-6) and its FD check, then 3 warm
   evaluations at h0 + k 1e-4 v, each from the previous d, with their
   median wall, the Newton iterations per pass and the factorizations;
   then the AIC's `torch.linalg.solve` (N = 1024) beside its bound;
18. VLM kernels: K11 vlm_aic (value 1e-12, VJP 1e-11 against its plain
   version, compared in norm over the whole matrix: at the root the real
   and mirrored trailing legs nearly cancel) on the full-width lattice (the
   20-patch wing, N = 6600, under 16 x 64 panels) at the deformed corners
   of a seeded d, and on the demo's 6 x 10 lattice, with both times; the
   VJP's bound counts its reverse sweep (SWEEP_AIC a pair), and the
   dual-number kernel it replaced stays beside it (`bound_ms_dual`); K5 at
   both lattices' corners (1105 and 77 points; conn equal, R 1e-13);
19. the Scordelis-Lo roof (goldfish_tpu_torch/models/slr.py) at num_el=6:
   the linear-regime QoI against the published 0.3006 (5e-3) and the JAX
   package's value in the same file (1e-8), and the displacement jump
   across the patch 0 | 1 interface; then K1-K4 at the roof's shapes,
   and, printed and not gated, K1 mode a at the roof's own equilibrium
   four ways with their gaps (`[slr-kernel own-d]`: kernel, plain,
   cancellation-free, plain at x moved by one ulp; ROADMAP C6);
20. contact kernels: the two-plate press of tests/test_contact.py (two
   clamped plates 0.12 apart, q = 120, k_pen = 1e7, r_max = 0.1; 2 patches,
   p = 2, 9 qps) at num_el=16 (N = 1944, 2304 qps per plate) at its
   continuation equilibrium plus seeded noise: K12 contact_pairs, its
   cull (the sorted list of element pairs equal to its plain twin
   `candidate_pairs`) and its three modes against their plain versions
   (the value 1e-12, the forces, the hvp and the stiffness 1e-11), with
   both times, the bound (f64 operations of the pairs within r_max) and
   the share of element pairs the cull dropped;
21. the press at num_el=32 (C = 1156, N = 6936, 9216 qps per plate): the
   counted path is `continuation_solve` (4 levels, rtol 1e-9) from d = 0,
   then `build_solve_fn` warm at the equilibrium, J = W_int and dJ/dh by
   the adjoint, and the central difference of dJ/dh along a seeded v; it
   must meet tests/test_contact.py's criteria (|r|/|r(0)| < 1e-8, W_c > 0,
   midspan deflection < -0.02, FD < 1e-5) and launch K12's three modes;
   then K12 against its plain versions and K1-K4 at this size, the same
   path at num_el=6 against tests/data/torch_port_contact_reference.json
   (d and W_c 1e-8, dJ/dh 1e-6), and cholesky_ex and K13 (phase 12's
   checks) at N = 6936;
22. Riks: tests/test_riks.py's shallow cylindrical panel (hinged, centre
   point load) at num_el=24 (N = 2028): `riks_solve` with the test's
   arguments must reach lam = 1 with |r| < 1e-5 |q|, trace the limit point
   (lam_peak > lam_valley + 0.2) and end at more than 3x the pre-limit
   |d|; the final d (1e-6) and lam_peak (1e-3) against the same file; then
   K1-K4 at the panel's shapes and `lu_factor_ex` at N = 2028 beside its
   bound;
23. the stress field (goldfish_tpu_torch/om_comps/components.VMStressComp)
   at the small plate (num_el=3, p=2) at the card's Newton solution: the
   counted path is run_model, compute_partials (the dense Jacobians from
   K9 mode 2's rows) and the operation's VJP (K9 mode 1), against the
   same on CPU tensors at the same inputs, each gated at how far the
   CPU's own result moves when CP_IGA and the displacements move by one
   ulp (the worst of three seeded moves), never below 1e-12;
24. the trimmed plate (goldfish_tpu_torch/demos/plate_hole_thickness_opt.py
   at its defaults: num_el=8, a circular hole, 4 x 4 sub-cells a knot
   span, cut-cell weights, void elements dropped): K1-K4 and K9's three
   modes at its stack against their plain versions (K3 summing runs of 16
   sub-cells on one dof map, printed; K9 gated at the worst of three
   one-ulp moves of its plain version, never below 4.2e-12 or its
   STRESS_TOL where tighter: ROADMAP C14), K9's rows against its VJP; the
   start J and gradient against tests/data/torch_port_cad_reference.json
   (1e-8, 1e-6); then the counted path, the demo's `main` (20 SLSQP
   iterations): J lowered, the end J within 1e-6 of the
   JAX run's, near > 1.05 far where the JAX run meets it (ROADMAP C12);
25. the variable-thickness plate (demos/thickness_opt_plate.py, num_el=4,
   30 iterations, its checkpoint and VTK files): start (1e-8, 1e-6), then
   the counted `main`: end J 1e-4 of the JAX run's;
26. the eVTOL wing (demos/evtol_wing_shopt.py, 3 sections, num_el=3, p=3):
   the IGES round trip, the preprocessor's intersections equal to the CPU
   port's (1e-10; its walls and whether the native kernel ran), K1-K4, K2
   and K8's three modes at its stack against their plain versions (1e-11),
   start (J 1e-4, gradient 1e-2: ROADMAP C13), then the counted path (the
   setup and 5 SLSQP iterations): J lowered, end 1e-3;
27. the curved moving-seam T-beam (demos/shape_opt_mint_tbeam_curved.py,
   num_el=4, p=3): the preprocessor's traced seam polished by CPIGA2Xi on
   the card against the CPU port's (1e-10), K5-K7 and K1-K4 at its shapes
   (`phase_mi_kernels`), start (1e-8, 1e-6), then the counted path (the
   setup with its preprocessor and 4 SLSQP iterations): J lowered, end
   1e-4, the fused xi route;
28. the CADDEE wing (demos/caddee_aeroelastic_wing.py, 3 sections,
   num_el=3, p=3, 4 fixed-point passes): W_int and the tip displacement
   (1e-8) and dW_int/dh through the coupled adjoint (1e-6) against the
   JAX demo's;
29-32. the drivers, the CSDL layer, the contact force's forward design
   tangent and the remaining demos (`[drivers] phases 29-32`);
33. tbeam_stop: bench_mi's moving-seam T-beam at full width (num_el=40,
   p=3, 17 seam points) with an upward areal field load on the flange and
   a clamped stop plate above the outer 30% of the span, contact (flange,
   stop): K1-K7 at its shapes (`phase_mi_kernels`) and K12's modes at its
   equilibrium plus noise against their plain versions; the counted path:
   four warm load levels on one persistent MI factor (|r| <= 1e-8 |r(0)|
   each, W_c > 0 at the last), J = W_int with dJ/d(amp) and dJ/dh through
   the CP -> xi and displacement solves, their central differences (1e-5),
   and `DispMintImOperation`'s forward/reverse dot test with contact
   (1e-10); then the same path without contact against the JAX package's
   full-width field-load numbers (d and J 1e-8, gradients 1e-6) and at the
   tests' small size with contact against the JAX package's (the same
   gates, the operation's products 1e-10), both from
   tests/data/torch_port_contact_routes_reference.json;
34. press32_krylov: the press at num_el=32 without a dense factor on the
   Newton path: each of four load levels by `newton_krylov_solve` warm
   from the last (dense preconditioner), then the value and dJ/dh through
   `build_solve_fn_krylov` for each preconditioner (dense, patch blocks;
   pair-Schwarz refuses a model without interfaces, as the reference's
   does), the GMRES cycles a Newton step, K10's patch blocks against their
   plain version at the press's shapes; d and J (1e-8) and dJ/dh (1e-6)
   against phase 21's dense route, and num_el=6 against the JAX dense
   numbers of tests/data/torch_port_contact_reference.json.

Wherever K3 is checked, the smoke prints its groups, the runs of equal dof
maps it sums before adding (`jet_runs`) and the atomics into K one per
group (the design before the runs) and one per run.

From the build on, torch.cholesky_solve and torch.linalg.cholesky_ex on a
CUDA tensor raise outside the yardsticks and the plain versions
(`guard_cholesky_solve`, `guard_cholesky_ex`): every Cholesky factor of a
main path is K14's and every Cholesky solve goes through K13; every path
that made a Cholesky factor on the card must show K14's launches and
K13's one-column launches (`chol_needed`); the wing, MI, tube, plate,
pegasus dense, press, VLM and sharded paths must show them in any case,
the MI path also the Woodbury basis's.

Launch counters, reset just before each main path and read just after,
prove that the path went through its kernels; after each path the group
shapes K4 ran at are printed with the instantiation that served them. The
line before the last is the kernels' JSON record (`launches` sums the main
paths; the probe's launches stand apart under `launches_pegasus_probe`);
the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(ROOT, "tests", "data", "torch_port_wing20_reference.json")
REF_MI = os.path.join(ROOT, "tests", "data",
                      "torch_port_mi_tbeam40_reference.json")
REF_TUBE = os.path.join(ROOT, "tests", "data",
                        "torch_port_tube16_reference.json")
REF_PLATE = os.path.join(ROOT, "tests", "data",
                         "torch_port_plate32_reference.json")
REF_PEG = os.path.join(ROOT, "tests", "data",
                       "torch_port_pegasus91_reference.json")
REF_VLM = os.path.join(ROOT, "tests", "data",
                       "torch_port_vlm_reference.json")
REF_OM_MI = os.path.join(ROOT, "tests", "data",
                         "torch_port_om_mi_reference.json")
REF_CONTACT = os.path.join(ROOT, "tests", "data",
                           "torch_port_contact_reference.json")
REF_5B = os.path.join(ROOT, "tests", "data",
                      "torch_port_om_mi_5b_reference.json")
REF_CAD = os.path.join(ROOT, "tests", "data",
                       "torch_port_cad_reference.json")
REF_DRIVERS = os.path.join(ROOT, "tests", "data",
                           "torch_port_drivers_reference.json")
REF_ROUTES = os.path.join(ROOT, "tests", "data",
                          "torch_port_contact_routes_reference.json")
CONTACT_TOL = {"contact_pairs/value_grad": 1e-11, "contact_pairs/hvp": 1e-11,
               "contact_pairs/hess": 1e-11, "contact_pairs/cull": 0.0,
               "contact_pairs/design_fwd": 1e-11}
VLM_WIDE = dict(n_chord=4, n_span=5, num_el=6, p=3, mc=16, ns=64)
VLM_DEMO = dict(n_chord=2, n_span=3, num_el=3, p=3, mc=6, ns=10)
VLM_TOL = {"vlm_aic/value": 1e-12, "vlm_aic/vjp": 1e-11}
K10_TOL = {"pair_assemble/patches": 1e-13,
           "pair_assemble/pairs": 1e-13}
PEG = dict(n_sections=18, num_el=3, p=3)   # the reference's full box wing
# sha256 of K2's outputs on the card at `k2_bits`' input, as the parent
# tree of the extended penalty_sweep.cuh gave them
K2_BITS = os.path.join(ROOT, "tests", "data", "torch_port_k2_bits.json")
# sha256 of K13's outputs on the card at `k13_bits`' input, as the parent
# tree of the shared csrc/chol_blocks.cuh gave them
K13_BITS = os.path.join(ROOT, "tests", "data", "torch_port_k13_bits.json")
KERNEL_TOL = 1e-11
STRESS_TOL = {"vm_stress_qp/value": 1e-12, "vm_stress_qp/vjp": 1e-11,
              "vm_stress_qp/rows": 1e-12}
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the f64 rate outside the
# tensor cores and the f64 tensor-core (DMMA) rate: the bound of the dense
# factorizations and of K10, whose per-group B^T H B is a block product
PEAK_BYTES = 3.35e12
PEAK_F64 = 34e12
PEAK_F64_TC = 67e12


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` launches (CUDA events). Where
    one call takes the host less than 2 ms, the card first spins
    (torch.cuda._sleep) for twice the host's time to enqueue the launches,
    so that they run back to back: the wrapper's own host time (its checks
    and the ctypes call, ~15-30 us) is not counted as device time."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    if host < 2e-3:
        torch.cuda._sleep(int(min(2.0 * reps * host + 1e-4, 0.05) * 2e9))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


_FLUSH = []


def cuda_ms_cold(fn, reps):
    """Median device time of fn() over `reps` launches (CUDA events), each
    after writing a 256 MB scratch tensor (5x the 50 MB L2) outside the
    timed window, so that fn reads its inputs from device memory as it
    does in a solver loop between factor substitutions. While the card
    writes, the host enqueues fn, so its host time is not counted."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(2 ** 25, dtype=torch.float64,
                                  device="cuda"))
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        _FLUSH[0].fill_(1.0)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


# kernels also timed with the L2 flushed before each launch
COLD_TIMED = ("jet_matvec",)


def rel_err(a, b):
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    den = float(torch.linalg.norm(b))
    return float(torch.linalg.norm(a - b)) / (den if den > 0 else 1.0), \
        float((a - b).abs().max())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound(bytes_, flops, peak=PEAK_F64):
    """Least time (ms) for the work on the card: the larger of bytes over
    the memory rate and f64 operations over the f64 rate `peak`."""
    tb = bytes_ / PEAK_BYTES * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build():
    from goldfish_tpu_torch import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    say(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(built={_cuda.build_info['built']}) -> {_cuda.build_info['path']}")
    with open(_cuda.build_info["ptxas_log"]) as fh:
        log = fh.read()
    for line in log.splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            say("[ptxas] " + line.strip())
    spills = ptxas_spills(log)
    for name, (regs, st, ld, frame) in spills.items():
        if any(k in name for k in REDESIGNED):
            say(f"[ptxas-redesigned] {name}: {regs} registers, spill "
                f"stores {st} B, spill loads {ld} B, stack frame {frame} B")
    for k in REDESIGNED_NO_SPILL:
        got = [v for n, v in spills.items() if k in n]
        if not got or any(st or ld for _, st, ld, _ in got):
            raise RuntimeError(f"{k} spills or is missing: {got}")
    for k in K5K7_ENTRIES + K6_ENTRIES:
        got = [v for n, v in spills.items() if k in n]
        if any(frame for *_, frame in got):
            raise RuntimeError(f"{k} has a stack frame: {got}")


# entry functions of the kernels redesigned for the H100 (K1's four modes,
# K2's three, K4, K12's cull and work kernels, K3, K8's three modes (the
# template `pressure_grad_block` is modes 0 and 2), K11's two, K5, K7's four
# modes (the template `c2x_kernel`) and its cross-intersection sum, K6, K9's
# value, VJP, gather and rows kernels, K10's two stages (each instantiated for 1
# and 3 (l, m) pairs a thread), K13's three, K14's update, its split parts'
# sum and its panel), and those of them that must not spill;
# K5's, K7's and K6's also have no stack frame
K1K2_ENTRIES = ("shell_value_grad", "shell_hess", "shell_adjoint",
                "shell_geom_grad", "shell_design_jvp", "penalty_value_grad",
                "penalty_hess", "penalty_adjoint", "penalty_design_jvp")
K8K11_ENTRIES = ("pressure_grad_block", "pressure_hess", "aic_value_kernel",
                 "aic_vjp_kernel")
K5K7_ENTRIES = ("traced_rows_kernel", "c2x_kernel", "c2x_reduce_dcp")
K6_ENTRIES = ("mi_penalty_xi_kernel", "mi_penalty_xi_fwd_kernel")
K9_ENTRIES = ("vm_value", "vm_vjp_elements", "vm_gather", "vm_rows")
K10_ENTRIES = ("patch_assemble_kernel", "pair_assemble_kernel")
K13_ENTRIES = ("diag_inv_kernel", "subst_vec_kernel", "subst_multi_kernel")
K14_ENTRIES = ("update_kernel", "reduce_kernel", "panel_kernel")
REDESIGNED = K1K2_ENTRIES + K8K11_ENTRIES + K5K7_ENTRIES + K6_ENTRIES + \
    K9_ENTRIES + K10_ENTRIES + K13_ENTRIES + K14_ENTRIES + (
    "jet_matvec", "cell_box_kernel", "cull_kernel", "pair_list_kernel",
    "pair_hess_kernel", "jet_assemble_kernel")
REDESIGNED_NO_SPILL = K1K2_ENTRIES + K8K11_ENTRIES + K5K7_ENTRIES + \
    K6_ENTRIES + K9_ENTRIES + K10_ENTRIES + K13_ENTRIES + K14_ENTRIES + (
    "cell_box_kernel", "cull_kernel", "pair_list_kernel", "pair_hess_kernel",
    "jet_assemble_kernel")


def ptxas_spills(log):
    """{kernel: (registers, spill store bytes, spill load bytes, stack
    frame bytes)} of every entry function in an `nvcc -Xptxas -v` log
    (names demangled where c++filt exists)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [0, 0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur in out:
            out[cur][1:] = [int(m.group(2)), int(m.group(3)),
                            int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in out:
            out[cur][0] = int(m.group(1))
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True).stdout.split(
            "\n")
        out = {n.strip() or k: v for n, k, v in zip(names, out, out.values())}
    return {k: tuple(v) for k, v in out.items()}


# name, source, replaced JAX device program (file:line)
KERNELS = [
    ("shell_qp/value_grad", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:142"),
    ("shell_qp/hess", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:198"),
    ("shell_qp/adjoint", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/solver/implicit.py:516"),
    ("shell_qp/geom_grad", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:142"),
    ("penalty_qp/value_grad", "goldfish_tpu_torch/csrc/penalty_qp.cu",
     "goldfish_tpu/physics/coupling.py:270"),
    ("penalty_qp/hess", "goldfish_tpu_torch/csrc/penalty_qp.cu",
     "goldfish_tpu/physics/coupling.py:318"),
    ("penalty_qp/adjoint", "goldfish_tpu_torch/csrc/penalty_qp.cu",
     "goldfish_tpu/solver/implicit.py:516"),
    ("shell_qp/design_fwd", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/operations/disp_imop.py:68"),
    ("penalty_qp/design_fwd", "goldfish_tpu_torch/csrc/penalty_qp.cu",
     "goldfish_tpu/operations/disp_mi_imop.py:221"),
    ("mi_penalty_xi/xi_fwd", "goldfish_tpu_torch/csrc/mi_penalty_xi.cu",
     "goldfish_tpu/operations/disp_mi_imop.py:221"),
    ("c2x_res_jac/cp_fwd", "goldfish_tpu_torch/csrc/c2x_res_jac.cu",
     "goldfish_tpu/operations/disp_mi_imop.py:115"),
    ("jet_assemble", "goldfish_tpu_torch/csrc/jet_assemble.cu",
     "goldfish_tpu/solver/system.py:194"),
    ("jet_matvec", "goldfish_tpu_torch/csrc/jet_matvec.cu",
     "goldfish_tpu/solver/system.py:104"),
    ("traced_rows", "goldfish_tpu_torch/csrc/traced_rows.cu",
     "goldfish_tpu/ops/bspline_jax.py:124"),
    ("mi_penalty_xi", "goldfish_tpu_torch/csrc/mi_penalty_xi.cu",
     "goldfish_tpu/solver/system_mi.py:1038"),
    ("c2x_res_jac/res_jac", "goldfish_tpu_torch/csrc/c2x_res_jac.cu",
     "goldfish_tpu/geometry/cpiga2xi.py:202"),
    ("c2x_res_jac/adjoint", "goldfish_tpu_torch/csrc/c2x_res_jac.cu",
     "goldfish_tpu/geometry/cpiga2xi.py:356"),
    ("c2x_res_jac/step", "goldfish_tpu_torch/csrc/c2x_res_jac.cu",
     "goldfish_tpu/geometry/cpiga2xi.py:293"),
    ("c2x_res_jac/solve_adjoint", "goldfish_tpu_torch/csrc/c2x_res_jac.cu",
     "goldfish_tpu/geometry/cpiga2xi.py:366"),
    ("pressure_qp/value_grad", "goldfish_tpu_torch/csrc/pressure_qp.cu",
     "goldfish_tpu/physics/loads.py:146"),
    ("pressure_qp/hess", "goldfish_tpu_torch/csrc/pressure_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:198"),
    ("pressure_qp/adjoint", "goldfish_tpu_torch/csrc/pressure_qp.cu",
     "goldfish_tpu/solver/implicit.py:516"),
    ("vm_stress_qp/value", "goldfish_tpu_torch/csrc/vm_stress_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:339"),
    ("vm_stress_qp/vjp", "goldfish_tpu_torch/csrc/vm_stress_qp.cu",
     "goldfish_tpu/physics/objectives.py:97"),
    ("vm_stress_qp/rows", "goldfish_tpu_torch/csrc/vm_stress_qp.cu",
     "goldfish_tpu/operations/exops.py:135"),
    ("pair_assemble/pairs", "goldfish_tpu_torch/csrc/pair_assemble.cu",
     "goldfish_tpu/solver/krylov.py:177"),
    ("pair_assemble/patches", "goldfish_tpu_torch/csrc/pair_assemble.cu",
     "goldfish_tpu/solver/krylov.py:59"),
    ("vlm_aic/value", "goldfish_tpu_torch/csrc/vlm_aic.cu",
     "goldfish_tpu/physics/vlm.py:126"),
    ("vlm_aic/vjp", "goldfish_tpu_torch/csrc/vlm_aic.cu",
     "goldfish_tpu/physics/vlm.py:162"),
    ("contact_pairs/cull", "goldfish_tpu_torch/csrc/contact_pairs.cu",
     "goldfish_tpu/physics/contact.py:58"),
    ("contact_pairs/value_grad", "goldfish_tpu_torch/csrc/contact_pairs.cu",
     "goldfish_tpu/physics/contact.py:58"),
    ("contact_pairs/hvp", "goldfish_tpu_torch/csrc/contact_pairs.cu",
     "goldfish_tpu/solver/system.py:104"),
    ("contact_pairs/hess", "goldfish_tpu_torch/csrc/contact_pairs.cu",
     "goldfish_tpu/physics/contact.py:79"),
    ("contact_pairs/design_fwd", "goldfish_tpu_torch/csrc/contact_pairs.cu",
     "goldfish_tpu/operations/disp_imop.py:68"),
    ("chol_subst/vec", "goldfish_tpu_torch/csrc/chol_subst.cu",
     "goldfish_tpu/solver/tpu_cholesky.py:205"),
    ("chol_subst/multi", "goldfish_tpu_torch/csrc/chol_subst.cu",
     "goldfish_tpu/solver/tpu_cholesky.py:235"),
    ("chol_subst/diag_inv", "goldfish_tpu_torch/csrc/chol_subst.cu",
     "goldfish_tpu/solver/tpu_cholesky.py:177"),
    ("chol_factor", "goldfish_tpu_torch/csrc/chol_factor.cu",
     "goldfish_tpu/solver/tpu_cholesky.py:139"),
]
WING_KERNELS = ("shell_qp/value_grad", "shell_qp/hess", "shell_qp/adjoint",
                "penalty_qp/value_grad", "penalty_qp/hess",
                "penalty_qp/adjoint", "jet_assemble", "jet_matvec")
# K7's modes 0 and 1 run only in the rare damped step and on seams past
# the fused route's size: not required on a main path
MI_PATH_KERNELS = WING_KERNELS + (
    "shell_qp/geom_grad", "traced_rows", "mi_penalty_xi",
    "c2x_res_jac/step", "c2x_res_jac/solve_adjoint")
# the OM graph's linearize keeps K7 mode 0's Jacobian and its reverse
# products take mode 1; its xi Newton takes mode 2 (its totals run no mode 3)
OM_MI_KERNELS = WING_KERNELS + (
    "shell_qp/geom_grad", "traced_rows", "mi_penalty_xi",
    "c2x_res_jac/res_jac", "c2x_res_jac/adjoint", "c2x_res_jac/step")
PRESSURE_KERNELS = ("pressure_qp/value_grad", "pressure_qp/hess",
                    "pressure_qp/adjoint")
# the 4-patch tube through the OpenMDAO graph: the OM MI kernels and the
# follower pressure's
TUBE_OM_MI_KERNELS = OM_MI_KERNELS + PRESSURE_KERNELS
TUBE_KERNELS = WING_KERNELS + ("shell_qp/geom_grad",) + PRESSURE_KERNELS
TUBE_MI_KERNELS = MI_PATH_KERNELS + PRESSURE_KERNELS
PLATE_KERNELS = WING_KERNELS + ("vm_stress_qp/value", "vm_stress_qp/vjp")
PEG_PROBE_KERNELS = ("pair_assemble/pairs", "pair_assemble/patches",
                     "jet_assemble", "jet_matvec")
VLM_KERNELS = WING_KERNELS + ("traced_rows", "vlm_aic/value", "vlm_aic/vjp")
# a cold solve on a fresh factor takes substitution directions only: no K4
SLR_KERNELS = ("shell_qp/value_grad", "shell_qp/hess", "penalty_qp/value_grad",
               "penalty_qp/hess", "jet_assemble")
PRESS_KERNELS = ("shell_qp/value_grad", "shell_qp/hess", "shell_qp/adjoint",
                 "jet_assemble", "jet_matvec", "contact_pairs/cull",
                 "contact_pairs/value_grad",
                 "contact_pairs/hvp", "contact_pairs/hess")
RIKS_KERNELS = ("shell_qp/value_grad", "shell_qp/hess", "jet_assemble")
CONTACT_KERNELS = ("contact_pairs/cull", "contact_pairs/value_grad",
                   "contact_pairs/hvp", "contact_pairs/hess")
# the MI path with contact and the operation's forward products: K12's
# four modes, the design-tangent modes of K1, K2, K6
TBEAM_STOP_KERNELS = MI_PATH_KERNELS + CONTACT_KERNELS + (
    "contact_pairs/design_fwd", "shell_qp/design_fwd", "penalty_qp/design_fwd",
    "mi_penalty_xi/xi_fwd")
# the Newton-Krylov press: K4 in every Arnoldi step, K3 into the dense
# preconditioner, K10's patch blocks; no interface, so no K2
PRESS_KRYLOV_KERNELS = ("shell_qp/value_grad", "shell_qp/hess",
                        "shell_qp/adjoint", "jet_assemble", "jet_matvec",
                        "pair_assemble/patches") + CONTACT_KERNELS
# one trimmed patch: no interfaces
TRIM_KERNELS = ("shell_qp/value_grad", "shell_qp/hess", "shell_qp/adjoint",
                "jet_assemble", "jet_matvec")
# the stress field's operation: its value, dense Jacobians and VJP
VMSTRESS_KERNELS = ("vm_stress_qp/value", "vm_stress_qp/rows",
                    "vm_stress_qp/vjp")

# f64 operations of one density evaluation (counted from the sources); a
# dual-number kernel mode's count is that times the dual components it
# carries (K1 and K2 before their reverse sweeps: the `bound_ms_dual`
# yardstick)
DENS_SHELL, DENS_PEN, DENS_VM = 200, 250, 300
# f64 operations of K9's reverse sweep a qp (csrc/vm_stress_qp.cu:
# vm_sweep, counted from the source: s_ij and the frame ~130, S^ab, A^-1
# and the strains ~120, the current and reference configurations ~200)
SWEEP_VM = 450
# f64 operations of one hand-written reverse sweep at a qp (counted from
# csrc/shell_qp.cu:shell_sweep and csrc/penalty_sweep.cuh), in plain
# doubles, without and with the sweep back through the geometry; a
# Dual<double, 1> tangent makes an operation ~2.5
SWEEP_SHELL, SWEEP_SHELL_GEO = 320, 580
SWEEP_PEN, SWEEP_PEN_GEO = 380, 580
TANGENT = 2.5
# f64 operations of one AIC entry: two horseshoes of a bound segment (~50)
# and two semi-infinite legs (~36 each), and the dot with the normal
AIC_OPS = 265
# f64 operations of K11's VJP a pair (counted from csrc/vlm_aic.cu): two
# `horseshoe_rev` sweeps (315 each: the shared r1, r2, r0, norms and their
# reciprocals 25, the bound segment forward and back 102, each leg 78, the
# norms' and ends' pullbacks 32), the cotangent g n, the mirror's fold and
# dn = g v (18); a division or square root counts one
SWEEP_AIC = 648
# f64 operations of one qp pair within r_max in K12 (counted from
# csrc/contact_pairs.cu): the distance and cubic (~20), then the force and
# the two weighted potentials (~12), the hvp's projection and 3-vector
# (~35), the hess mode's 3x3 block (~30), the design tangent's hvp terms
# and its weights' term (~45); a hess element pair adds the product
# 2 * 9 Q L (Q + L) of its cross quadrant
CONTACT_OPS = {"contact_pairs/value_grad": 32, "contact_pairs/hvp": 55,
               "contact_pairs/hess": 50, "contact_pairs/design_fwd": 65}


# cull: per cell pair the squared box gap and its test (~12), per qp the
# box update (6)
CULL_OPS_PAIR, CULL_OPS_QP = 12, 6


def assemble_ops(R):
    """f64 operations of K3 on groups of rows R (G, nq, nj, nloc): per qp
    T = H B (nz x 3nloc, nj MACs each) and B^T T ((3nloc)^2, nj each)."""
    G, nq, nj, nloc = R.shape
    n3 = 3 * nloc
    return G * nq * 2 * nj * n3 * (3 * nj + n3)


def k3_runs(tag, groups, free):
    """Print each K3 group's count, its runs of equal dof maps and the
    atomics into K one per group and one per run (every entry of the (3
    nloc)^2 block; between free dofs)."""
    from goldfish_tpu_torch.solver import system

    parts = []
    for name, gi in groups:
        starts, lengths = system.jet_runs(gi)
        n3 = gi.shape[1]
        nf = (free[gi.long()] != 0).sum(1).double() ** 2
        parts.append(
            f"{name} {gi.shape[0]} groups in {starts.numel()} runs "
            f"(longest {int(lengths.max())}), atomics one per group "
            f"{gi.shape[0] * n3 * n3} -> one per run "
            f"{starts.numel() * n3 * n3}"
            f" (free dofs {int(nf.sum())} -> {int(nf[starts].sum())})")
    say(f"[{tag}] K3 " + "; ".join(parts))


def fixed_cases(data, d, cp, h, lam, v, tag=None):
    """name -> (kernel fn, plain fn, flops, inputs) of K1-K4 on the card,
    on a SystemData (its stack and, where it has one, its interface stack)
    at state d; K2 where there are interfaces. With `tag`, K3's groups and
    runs are printed (`k3_runs`)."""
    from goldfish_tpu_torch.physics import coupling, kl_shell
    from goldfish_tpu_torch.solver import system

    st, ifs = data.stack, data.ifs
    E, nu = data.E, data.nu
    tables = system.jet_tables(data)
    Hs = system.jet_hessians(data, d, cp, h)
    free = tables.free
    N = free.shape[0]
    dev = free.device

    groups = [(Hs[0], tables.R_e, tables.gi_e)]
    if Hs[1] is not None:
        groups.append((Hs[1], tables.R_i, tables.gi_i))
    if Hs[2] is not None:   # the follower pressure's group
        groups.append((Hs[2], tables.R_p, tables.gi_e))
    if tag:
        k3_runs(tag, [(n, g[2]) for n, g in zip(
            ("shell", "interface" if Hs[1] is not None else "pressure",
             "pressure"), groups)], free)

    def assemble(fn):
        K = torch.zeros(N, N, dtype=torch.float64, device=dev)
        for H, R, gi in groups:
            fn(K, H, R, gi, free)
        return K

    def matvec(fn):
        y = torch.zeros(N, dtype=torch.float64, device=dev)
        vf = v.reshape(-1)
        for H, R, gi in groups:
            fn(y, H, R, gi, free, vf)
        return y

    P, Ne, Q, L = st.R00.shape
    nqp = P * Ne * Q
    jets_s = 2 * 15 * L * 2 + 2 * L          # X, z jets + h per qp
    # the design tangent (tcp, th): v and lam's first component (seeded)
    tcp, th = v, lam[..., 0].contiguous()
    # K3: T = H B and B^T T per qp (`assemble_ops`); K4: gather, H z,
    # scatter
    asm = sum(assemble_ops(R) for _, R, _ in groups)
    g_e = tables.R_e.shape[0]
    mv = g_e * Q * (12 * 5 * L + 450)
    if Hs[1] is not None:
        g_i, Li = tables.R_i.shape[0], ifs.RA00.shape[2]
        mv += g_i * (12 * 6 * 2 * Li + 648)
    if Hs[2] is not None:
        mv += g_e * Q * (12 * 3 * L + 162)
    # K1 mode b's structured algorithm (its bound): the jets once a qp, 6
    # columns of a tangent reverse sweep (~6 density evaluations each), the
    # 81 s-s entries; the 15-column dual-over-dual count of the kernel it
    # replaced stays beside it as a yardstick (`bound_ms_15col`)
    hess_structured = nqp * (jets_s + 6 * 6 * DENS_SHELL + 3 * 81)
    base = [d, cp, h, E, nu, data.free]
    shell_in = base + list(st)
    jet_in = [t for t in tables if isinstance(t, torch.Tensor)] + \
        [t for t in Hs[:3] if t is not None]
    # K4 reads every group's H, R and dof map once, free and v
    mv_in = list({id(t): t for grp in groups for t in grp}.values()) + [free]
    cases = {
        "shell_qp/value_grad": (
            lambda: kl_shell.shell_value_grad(st, d, cp, h, E, nu),
            lambda: kl_shell._value_grad_plain(st, d, cp, h, E, nu),
            nqp * (jets_s + 32 * L + SWEEP_SHELL), shell_in,
            {"flops_dual": nqp * (jets_s + 17 * DENS_SHELL)}),
        "shell_qp/hess": (
            lambda: kl_shell.shell_hessians(st, d, cp, h, E, nu),
            lambda: kl_shell._hessians_plain(st, d, cp, h, E, nu),
            hess_structured, shell_in,
            {"flops_15col": nqp * 15 * (jets_s + 32 * DENS_SHELL)}),
        "shell_qp/adjoint": (
            lambda: kl_shell.shell_adjoint(st, d, cp, h, E, nu, lam),
            lambda: kl_shell._adjoint_plain(st, d, cp, h, E, nu, lam),
            nqp * (jets_s * 3 // 2 + 32 * L + TANGENT * SWEEP_SHELL_GEO),
            shell_in + [lam],
            {"flops_dual": nqp * (jets_s * 3 // 2 + 34 * DENS_SHELL)}),
        # the forward design tangent along (tcp, th): mode a's sweep with
        # X's jets and h as a Dual<double, 1> tangent
        "shell_qp/design_fwd": (
            lambda: kl_shell.shell_design_jvp(st, d, cp, h, E, nu, tcp, th),
            lambda: kl_shell._design_jvp_plain(st, d, cp, h, E, nu, tcp,
                                               th),
            nqp * (jets_s * 3 // 2 + L + 30 * L + TANGENT * SWEEP_SHELL),
            shell_in + [tcp, th]),
        "jet_assemble": (lambda: assemble(system.jet_assemble),
                         lambda: assemble(system._assemble_plain), asm,
                         jet_in),
        "jet_matvec": (lambda: matvec(system.jet_matvec),
                       lambda: matvec(system._matvec_plain), mv,
                       mv_in + [v]),
    }
    if ifs is None:
        return cases
    I_, Nq, Li = ifs.RA00.shape
    nip = I_ * Nq
    jets_p = 2 * (9 * Li * 2 + 2 * Li) * 2    # both sides, X, z, h
    scat_p = 2 * Li * 20                       # both sides, B^T g and h
    pen_in = base + list(ifs)
    # the reverse sweep's count (K2's bound); the dual-number count of the
    # kernel it replaced beside it (`bound_ms_dual`)
    cases.update({
        "penalty_qp/value_grad": (
            lambda: coupling.penalty_value_grad(ifs, d, cp, h, E),
            lambda: coupling._value_grad_plain(ifs, d, cp, h, E),
            nip * (jets_p + scat_p + SWEEP_PEN), pen_in,
            {"flops_dual": nip * (jets_p + 21 * DENS_PEN)}),
        "penalty_qp/hess": (
            lambda: coupling.penalty_hessians(ifs, d, cp, h, E),
            lambda: coupling._hessians_plain(ifs, d, cp, h, E),
            nip * (jets_p + 12 * TANGENT * SWEEP_PEN), pen_in,
            {"flops_dual": nip * 18 * (jets_p + 38 * DENS_PEN)}),
        "penalty_qp/adjoint": (
            lambda: coupling.penalty_adjoint(ifs, d, cp, h, E, lam),
            lambda: coupling._adjoint_plain(ifs, d, cp, h, E, lam),
            nip * (jets_p * 3 // 2 + scat_p + TANGENT * SWEEP_PEN_GEO),
            pen_in + [lam],
            {"flops_dual": nip * (jets_p * 3 // 2 + 30 * DENS_PEN)}),
        "penalty_qp/design_fwd": (
            lambda: coupling.penalty_design_jvp(ifs, d, cp, h, E, tcp, th),
            lambda: coupling._design_jvp_plain(ifs, d, cp, h, E, tcp, th),
            nip * (jets_p * 3 // 2 + scat_p + TANGENT * SWEEP_PEN),
            pen_in + [tcp, th]),
    })
    return cases


def geom_grad_case(st, d, cp, h, E, nu):
    """K1 mode d (dW/dcp) on stack `st`: (kernel fn, plain fn, flops,
    inputs, the dual-number yardstick): per qp the X and z jets and h, the
    sweep with its geometry part, B^T g (30 a local)."""
    from goldfish_tpu_torch.physics import kl_shell

    P, Ne, Q, L = st.R00.shape
    jets = 2 * 15 * L * 2 + 2 * L
    return (lambda: kl_shell.shell_geom_grad(st, d, cp, h, E, nu),
            lambda: kl_shell._geom_grad_plain(st, d, cp, h, E, nu),
            P * Ne * Q * (jets + 30 * L + SWEEP_SHELL_GEO),
            list(st) + [d, cp, h],
            {"flops_dual": P * Ne * Q * (jets + 16 * DENS_SHELL)})


def pressure_cases(data, d, cp, lam):
    """K8 in its three modes on the stack of `data` (which has a follower
    pressure): name -> (kernel fn, plain fn, flops, inputs)."""
    from goldfish_tpu_torch.physics import loads

    st, pr = data.stack, data.pressure
    P, Ne, Q, L = st.R00.shape
    nqp = P * Ne * Q
    ins = [st.R00, st.R10, st.R01, st.conn, st.wq, d, cp, pr]
    # per qp: 9-jet gathers (36 flops per local and field), the triple
    # products and cross products (~70), the scatter (18 per local); the
    # Hessian's closed form: c and its 54 nonzero entries +-c y_m
    return {
        "pressure_qp/value_grad": (
            lambda: loads.pressure_value_grad(st, d, cp, pr),
            lambda: loads._pressure_value_grad_plain(st, d, cp, pr),
            nqp * (54 * L + 70), ins),
        "pressure_qp/hess": (
            lambda: loads.pressure_hessians(st, d, cp, pr),
            lambda: loads._pressure_hessians_plain(st, d, cp, pr),
            nqp * (36 * L + 56), ins),
        "pressure_qp/adjoint": (
            lambda: loads.pressure_adjoint(st, d, cp, pr, lam),
            lambda: loads._pressure_adjoint_plain(st, d, cp, pr, lam),
            nqp * (72 * L + 72), ins + [lam]),
    }


def check_kernels(cases, tag, reps=5, tol=None):
    """Compare every kernel with its plain version (relative error in norm
    <= tol[name], default KERNEL_TOL); returns {name: dict} with the
    relative and max abs error, both times and the bound. A case may add
    the f64 rate of its bound (default PEAK_F64) and a dict whose
    "flops_<what>" gives a second bound, `bound_ms_<what>`, for the
    algorithm of the kernel it replaced (a yardstick). The
    kernels of COLD_TIMED add `ms_cold`. A dict with "compare" gives
    the (relative, max abs) error of the kernel's output against the plain
    version's, "outputs" the kernel's output tensors for the bound, and
    "also" {label: fn} further calls timed as `ms_<label>` (the library
    composite a fused kernel replaced)."""
    out = {}
    for name, (kern, plain, flops, inputs, *opt) in cases.items():
        peak = [o for o in opt if isinstance(o, float)]
        extra = next((o for o in opt if isinstance(o, dict)), {})
        a, b = kern(), plain()
        torch.cuda.synchronize()
        rel = mx = 0.0
        if "compare" in extra:
            rel, mx = extra["compare"](a, b)
            a = extra["outputs"](a)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            if x is None or "compare" in extra:
                continue
            if not bool(torch.isfinite(x.double()).all()):
                raise RuntimeError(f"{name}: non-finite kernel output")
            r, m = rel_err(x, y)
            rel, mx = max(rel, r), max(mx, m)
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, max(1, reps // 2))
        b_ms, b_by = bound(nbytes(*inputs, *a), flops, *peak)
        more = {}
        if name in COLD_TIMED:
            more["ms_cold"] = cuda_ms_cold(kern, reps)
        for k, v in extra.items():
            if k.startswith("flops_"):
                more["bound_ms_" + k[6:]] = bound(
                    nbytes(*inputs, *a), v, *peak)[0]
        for k, fn in extra.get("also", {}).items():
            more["ms_" + k] = cuda_ms(fn, reps)
        say(f"[{tag}] {name:22s} rel {rel:.3e} max_abs {mx:.3e} "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"bound {b_ms:.4f} ms ({b_by})"
            + "".join(f" {k} {v:.4f}" for k, v in more.items()))
        gate = (tol or {}).get(name, KERNEL_TOL)
        if not rel <= gate:
            raise RuntimeError(f"{name}: kernel vs plain rel err {rel:.3e} "
                               f"> {gate:g}")
        out[name] = dict(rel=rel, max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, **more)
    return out


def phase_kernels(sys_, reps=5, seed=0):
    """K1-K4 against their plain versions at a seeded state of the wing:
    d random at 1e-3 of the CP scale on free dofs, lam and v random."""
    dev = sys_.cp.device
    rng = np.random.default_rng(seed)
    cp = sys_.cp
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * sys_.data.free
    lam = T(rng.normal(size=tuple(cp.shape)))
    v = T(rng.normal(size=tuple(cp.shape)))
    cases = fixed_cases(sys_.data, d, cp, sys_.h_init, lam, v, "kernel")
    checks = check_kernels(cases, "kernel", reps)
    reproducibility("kernel", cases, ("shell_qp/value_grad",
                                      "penalty_qp/value_grad"))
    return checks


def reproducibility(tag, cases, names, runs=5, outputs="(W, r, dW/dh)"):
    """Printed, not gated (ROADMAP C2): the largest relative change, in
    norm, of each output of a kernel over `runs` launches on the same
    inputs. The reverse-sweep kernels sum an element's (K1, K8) or a qp's
    (K2) B^T g in a fixed order, but nodes shared between elements still
    gather their sums by f64 atomics in a run-dependent order."""
    for name in names:
        kern = cases[name][0]
        first = kern()
        worst = [0.0] * len(first)
        for _ in range(runs - 1):
            got = kern()
            worst = [max(w, rel_err(a, b)[0])
                     for w, a, b in zip(worst, got, first)]
        say(f"[{tag} C2] {name}: largest relative change over {runs} "
            f"launches {outputs} " + " ".join(f"{w:.3e}" for w in worst))


def k2_unrolled(ifs, d, cp, h, lam):
    """The interface stack `ifs` with every (qp, side, local) on a node of
    its own, and d, cp, h, lam gathered to match: each qp's jets, and so
    K2's work a qp, are unchanged, and no two qps add into one node, so
    K2's outputs do not depend on the order of its atomics."""
    I, N, L = ifs.connA.shape
    dev = d.device
    base = (torch.arange(I * N, device=dev).reshape(I, N, 1) * (2 * L)
            + torch.arange(L, device=dev))
    sides = ((ifs.pairA, ifs.connA, base), (ifs.pairB, ifs.connB, base + L))
    out = []
    for f in (d, cp, h, lam):
        fu = torch.zeros((f.shape[0], I * N * 2 * L) + tuple(f.shape[2:]),
                         dtype=f.dtype, device=dev)
        for pair, conn, cu in sides:
            pp = pair.long()[:, None, None].expand(I, N, L)
            fu[pp, cu] = f[pp, conn.long()]
        out.append(fu)
    ifs = ifs._replace(connA=base.to(ifs.connA.dtype).contiguous(),
                       connB=(base + L).to(ifs.connB.dtype).contiguous())
    return (ifs, *out)


def k2_bits(dev, **wing_kw):
    """K2's three modes on a wing's interface stack unrolled by
    `k2_unrolled` (default the CPU tests' small wing, 2 x 2 patches,
    num_el=3, p=3) at a seeded state: {output: tensor}, the node outputs
    at the nodes that hold a value, (I, N, 2 sides, L, ...)."""
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.physics import coupling

    s = wing.build(**(wing_kw or dict(n_chord=2, n_span=2, num_el=3, p=3)),
                   device=dev)
    rng = np.random.default_rng(0)
    cp = s.cp
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * s.data.free
    lam = T(rng.normal(size=tuple(cp.shape)))
    ifs, d, cp, h, lam = k2_unrolled(s.data.ifs, d, cp, s.h_init, lam)
    E = s.data.E
    I, N, L = ifs.connA.shape

    def compact(fu):
        # (I, N, 2, L, ...): the unrolled nodes that hold a value
        return torch.stack([
            fu[pair.long()[:, None, None].expand(I, N, L), conn.long()]
            for pair, conn in ((ifs.pairA, ifs.connA),
                               (ifs.pairB, ifs.connB))], 2)

    W, r, dh = coupling.penalty_value_grad(ifs, d, cp, h, E)
    dcp, dh2 = coupling.penalty_adjoint(ifs, d, cp, h, E, lam)
    return {"value_grad W": W, "value_grad r": compact(r),
            "value_grad dW/dh": compact(dh),
            "hess": coupling.penalty_hessians(ifs, d, cp, h, E),
            "adjoint dcp": compact(dcp), "adjoint dh": compact(dh2)}


def sha256(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def phase_k2_bits(dev):
    """[kernel K2 bits]: K2's outputs at `k2_bits`' input, bit for bit
    against those the parent tree of the extended penalty_sweep.cuh gave on
    the card (tests/data/torch_port_k2_bits.json)."""
    with open(K2_BITS) as fh:
        want = json.load(fh)["sha256"]
    got = {k: sha256(v) for k, v in k2_bits(dev).items()}
    same = {k: got[k] == want[k] for k in want}
    say(f"[kernel K2 bits] penalty_qp outputs bit for bit as the parent "
        f"tree's: {same}")
    if not all(same.values()):
        raise RuntimeError(f"K2's outputs changed: {same}")


def k13_bits(dev):
    """K13's outputs at seeded inputs: {name: tensor}, the diagonal
    inverses and the solves with 1, 40 and 130 columns on the
    `cholesky_ex` factor of the equilibrated SPD matrix (eigenvalues
    log-spaced over 1e8, numpy-seeded) at N = 700 and 1100."""
    from goldfish_tpu_torch.solver import cholesky as ch

    out = {}
    for N in (700, 1100):
        rng = np.random.default_rng(N)
        Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
        K = (Q * np.logspace(0.0, -8.0, N)) @ Q.T
        Kt = torch.tensor(0.5 * (K + K.T), device=dev)
        dsc = torch.rsqrt(Kt.diagonal().abs())
        Kt = dsc[:, None] * Kt * dsc[None, :]
        with library_calls():
            L = torch.linalg.cholesky_ex(Kt)[0]
        invs = ch.diag_inverses(L)
        out[f"{N} diag_inv"] = invs
        for k in (1, 40, 130):
            B = torch.tensor(rng.normal(size=(N, k)), device=dev)
            out[f"{N} solve k={k}"] = ch.chol_solve(L, dsc, B, invs)
    return out


def phase_k13_bits(dev):
    """[kernel K13 bits]: K13's outputs at `k13_bits`' input, bit for bit
    against those the parent tree of csrc/chol_blocks.cuh (the pieces K13
    and K14 share) gave on the card (tests/data/torch_port_k13_bits.json)."""
    with open(K13_BITS) as fh:
        want = json.load(fh)["sha256"]
    got = {k: sha256(v) for k, v in k13_bits(dev).items()}
    same = {k: got[k] == want[k] for k in want}
    say(f"[kernel K13 bits] chol_subst outputs bit for bit as the parent "
        f"tree's: {same}")
    if not all(same.values()):
        raise RuntimeError(f"K13's outputs changed: {same}")


def make_iteration(sys_, th, solve):
    from goldfish_tpu_torch.physics import kl_shell

    def opt_iteration(h_ffd, d0):
        hf = h_ffd.clone().requires_grad_(True)
        h = th(hf)
        d = solve(sys_.cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, sys_.cp, h, sys_.E,
                                     sys_.nu)
        J.backward()
        return J.detach(), d.detach(), hf.grad

    def timed(h_ffd, d0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J, d, g = opt_iteration(h_ffd, d0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ok = (bool(torch.isfinite(J)) and bool(torch.isfinite(d).all())
              and bool(torch.isfinite(g).all()) and d.shape == sys_.cp.shape
              and g.shape == h_ffd.shape)
        if not ok:
            raise RuntimeError("non-finite or misshapen iteration output")
        return J, d, g, dt

    return timed


def phase_main_path(sys_, dev):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    with open(REF) as fh:
        ref = json.load(fh)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    fac = solve.device_factor
    run = make_iteration(sys_, th, solve)
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64,
                      device=dev)

    reset_counts()
    J, d, g, t_cold = run(h0, sys_.zero_displacement())
    MAIN_COLD.update(J=float(J), g=g.detach().cpu(), wall=t_cold)
    eJ = abs(float(J) - ref["J"]) / abs(ref["J"])
    g_ref = torch.tensor(ref["dJ_dh_ffd"], dtype=torch.float64)
    eg = rel_err(g.cpu(), g_ref)[0]
    say(f"[main] cold iteration {t_cold:.3f} s  J={float(J)!r} "
        f"(ref {ref['J']!r}, rel {eJ:.2e})  |dJ/dh_ffd| rel {eg:.2e}  "
        f"|d|={float(torch.linalg.norm(d))!r} (ref {ref['d_norm']!r})")
    if not (eJ <= 1e-8 and eg <= 1e-6):
        raise RuntimeError(f"cold iteration disagrees with the JAX CPU "
                           f"reference: J rel {eJ:.2e}, grad rel {eg:.2e}")

    ws = SecantWarmStart()
    ws.update(h0, d)
    warm = []
    for k in range(1, 6):
        hk = h0 * (1.0 + 1e-4 * k)
        Jk, d, gk, dt = run(hk, ws.predict(hk, d))
        ws.update(hk, d)
        warm.append(dt)
        say(f"[main] warm iteration {k}/5 {dt:.3f} s J={float(Jk)!r} "
            f"newton its {solve.solver.last_its}")
    h_big = h0 * (1.0 + 1e-2)
    Jb, db, gb, t_ref = run(h_big, ws.predict(h_big, d))
    counts = dict(_cuda.launch_counts)
    say_shapes("main")
    say(f"[main] refactor iteration (1e-2) {t_ref:.3f} s J={float(Jb)!r} "
        f"newton its {solve.solver.last_its}")
    say(f"[main] warm median {float(np.median(warm)):.3f} s; "
        f"n_factor {fac.n_factor} (failed {fac.n_factor_failed})")
    say(f"[main] refactor_log {fac.refactor_log}")
    say(f"[main] cert_log tail {fac.cert_log[-16:]}")
    say(f"[main] launch counts {counts}")
    missing = [k for k in WING_KERNELS + CHOL if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    return counts, fac


# ------------------------------------------------------------ MI T-beam
def mi_state(sys_, seed=1):
    """A seeded MI state on the card: (cp, h, xi, d, lam). xi is the
    initial seam moved by up to 1e-3 inside its knot spans (clipped to the
    parametric domain), d the linear response to the tip load, lam
    random on free dofs."""
    from goldfish_tpu_torch.solver import system_mi

    dev = sys_.cp.device
    rng = np.random.default_rng(seed)
    cp, h = sys_.cp, sys_.h_init
    xi0 = sys_.c2x.xi0_flat
    xi = (xi0 + torch.tensor(1e-3 * rng.uniform(-1, 1, size=xi0.shape),
                             device=dev)).clamp(0.0, 1.0).contiguous()
    zero = torch.zeros_like(cp)
    K0 = system_mi.assemble_K_mi(*sys_.mi_args, zero, cp, h, xi)
    r0 = system_mi.residual_mi(*sys_.mi_args, zero, cp, h, xi)
    d = torch.linalg.solve(K0, -r0.reshape(-1)).reshape(cp.shape)
    lam = torch.tensor(rng.normal(size=tuple(cp.shape)), device=dev) \
        * sys_.data.free
    return cp, h, xi, d, lam


def edge_seam(dev):
    """A CPIGA2Xi whose seam runs along an edge of both patches
    (both_edges = 1), a stretched cp, a moved xi and a cotangent."""
    from goldfish_tpu_torch.geometry.cpiga2xi import CPIGA2Xi
    from goldfish_tpu_torch.geometry.patch_stack import (
        build_patch_stack,
        stack_control_points,
    )
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.physics.coupling import InterfaceSpec

    L = tbeam.LENGTH
    surfs = [tbeam.create_surf([[-1, 0, 0], [0, 0, 0], [-1, L, 0],
                                [0, L, 0]], 2, 3, 3),
             tbeam.create_surf([[0, 0, 0], [1, 0, 0], [0, L, 0],
                                [1, L, 0]], 2, 4, 3)]
    spec = InterfaceSpec(pair=(0, 1),
                         xi_ends_A=np.array([[1.0, 0.0], [1.0, 1.0]]),
                         xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                         n_mortar_el=6)
    c2x = CPIGA2Xi(surfs, [spec], n_pts_list=[7], device=dev)
    cp = stack_control_points(build_patch_stack(surfs, device=dev)[1],
                              device=dev)
    cp[..., 0] *= 1.02
    x0 = c2x.xi0_flat
    rng = np.random.default_rng(3)
    x = (x0 + torch.tensor(1e-3 * rng.normal(size=tuple(x0.shape)),
                           device=dev)).contiguous()
    g = torch.tensor(rng.normal(size=tuple(x0.shape)), device=dev)
    return c2x, cp, x, g


# K5's rows: conn equal, R within 1e-13 in norm; K7's fused step: dx
# within 1e-10 (the solve of a system of cond 1e3-1e5), |r(x)| within
# 1e-12 and |r(x + dx)| within 1e-12 |r(x)| (it inherits dx's rounding);
# the fused adjoint's dcp 1e-12
ROWS_TOL = 1e-13
FUSED_TOL = {"traced_rows": ROWS_TOL, "c2x_res_jac/step": 1e-10,
             "c2x_res_jac/solve_adjoint": 1e-12}
NORM_TOL = 1e-12
# f64 operations of K5 a point: two A2.3 recursions with their first
# derivatives (p = q = 3: ~60 each), the weights' products and sums and
# the quotient rule (~10 an entry of L = 16)
ROWS_OPS = 280
# f64 operations of K7 an owner (seam point) beyond its two side-points'
# evaluations (K5's rows, then S and dS/dxi, 18 L a side-point): its rows
# in closed form (the spacing row's differences, value and gradient, ~30)
# with their chain rule through dS/dxi (3 points x 2 columns x 5)
K7_FORM_OPS = 60
# a point's basis in plain doubles as the dual-number kernels count it
# (two 1D recursions + the tensor), times their dual components: K6 9, the
# parent's K7 modes 0 and 1 3, besides their Dual<double, 15> rows,
# 4 x 16 x 40 a seam point (the `bound_ms_dual` yardstick)
BASIS_OPS = 2 * 4 * 12 + 16 * 3
# f64 operations of K6 a point (counted from csrc/mi_penalty_xi.cu and
# bspline_rows.cuh: lane_row2): per side the two A2.3 recursions with first
# and second derivatives (~60 each), per basis function and side the
# tensor products, weights and quotient rule (~25), its share of the jets
# (2 x 25) and of the chain rule (~62); the sweep (penalty_sweep.cuh with
# ALL: SWEEP_PEN_GEO and the curve tangents' ~30) in a Dual<double, 1>
K6_ROWS_DIR, K6_ROWS_BASIS, K6_JETS, K6_CHAIN = 60, 25, 50, 62


def k6_ops(I, N, L):
    return I * N * (2 * (2 * K6_ROWS_DIR
                         + L * (K6_ROWS_BASIS + K6_JETS + K6_CHAIN))
                    + TANGENT * (SWEEP_PEN_GEO + 30))


# K6 mode 1 a point: the same rows, the rows' tangents (~9 a basis
# function), the jets and their tangents (2 x 32), the sweep without the
# geometry part (SWEEP_PEN) in a Dual<double, 1>, and each lane's dR^T g +
# R^T dg (~36)
K6_FWD_LANE = 9 + 64 + 36


def k6_fwd_ops(I, N, L):
    return I * N * (2 * (2 * K6_ROWS_DIR + L * (K6_ROWS_BASIS + K6_FWD_LANE))
                    + TANGENT * SWEEP_PEN)


def k7_ops(I, N, L):
    """f64 operations of K7's modes at I seams of N points, {counter
    suffix: (ops, the parent's dual-number count of the same work)}: the
    evaluations (both side-points of every owner), the closed-form rows,
    the adjoint's lam-weighted row sums (~36 an owner) and pullback -R0 g_P
    (6 L a side-point), and the dense LU of a seam's n = 4N system with its
    substitutions (2n^3/3 + 2n^2). The step evaluates twice (r(x + dx)
    builds no Jacobian) and forms the rows once; the adjoint evaluates
    once."""
    n = 4 * N
    ev = I * N * 2 * (ROWS_OPS + 18 * L)
    form = I * N * K7_FORM_OPS
    pull = I * N * (36 + 12 * L)
    solve = I * (2 * n ** 3 / 3 + 2 * n * n)
    dual = I * N * (2 * (BASIS_OPS * 3 + 18 * L) + 4 * 16 * 40)
    return {"res_jac": (ev + form, dual), "adjoint": (ev + pull, dual),
            "step": (2 * ev + form + solve, 2 * dual + solve),
            "solve_adjoint": (ev + form + pull + solve, 2 * dual + solve)}


def rows_case(ss, p, q, ip, pts):
    """K5 at points (ip, pts): its conn must equal the plain version's."""
    from goldfish_tpu_torch.ops import bspline_traced as bt

    def compare(a, b):
        if not torch.equal(a[0], b[0]):
            raise RuntimeError("traced_rows: conn differs from the plain "
                               "version's")
        return rel_err(a[1], b[1])

    sv = [ss.knots_u, ss.knots_v, ss.span_u_vals, ss.span_u_ids,
          ss.span_v_vals, ss.span_v_ids, ss.w, ss.n_v]
    return (lambda: bt.traced_rows(ss, p, q, ip, pts),
            lambda: bt._rows_plain(ss, p, q, ip, pts),
            ip.shape[0] * ROWS_OPS, sv + [ip, pts],
            {"compare": compare, "outputs": lambda a: a})


def fused_cases(ss, p, q, mi, cp, x, g, fixed):
    """K7 modes 2 and 3 at (cp, x, g) against their plain versions, each
    with the composed route it replaces timed beside it (`ms_composed`:
    mode 0, batched torch.linalg.solve, mode 0 at x + dx, or mode 1).
    Bound: `k7_ops`, the parent's dual-number count beside it
    (`bound_ms_dual`)."""
    from goldfish_tpu_torch.geometry import cpiga2xi

    ops = k7_ops(mi.n_int, mi.n_max, (p + 1) * (q + 1))

    def step_compare(a, b):
        dx = rel_err(a[0] - x, b[0] - x)
        r0 = rel_err(a[1][:, 0], b[1][:, 0])[0]
        r1 = float((a[1][:, 1] - b[1][:, 1]).abs().max()) \
            / float(b[1][:, 0].max())
        say(f"[fused step] dx rel {dx[0]:.3e}; |r(x)| rel {r0:.3e}; "
            f"|r(x + dx)| diff / |r(x)| {r1:.3e} (gates {1e-10:g}, "
            f"{NORM_TOL:g}, {NORM_TOL:g})")
        if not (r0 <= NORM_TOL and r1 <= NORM_TOL):
            raise RuntimeError(f"c2x_res_jac/step: norms disagree: {r0:.3e}"
                               f", {r1:.3e}")
        return dx

    return {
        ("c2x_res_jac/step",): (
            lambda: cpiga2xi.c2x_step(ss, p, q, mi, cp, x),
            lambda: cpiga2xi._step_plain(ss, p, q, mi, cp, x),
            ops["step"][0], fixed + [cp, x],
            {"compare": step_compare, "outputs": lambda a: a,
             "flops_dual": ops["step"][1],
             "also": {"composed": lambda: cpiga2xi._step_composed(
                 ss, p, q, mi, cp, x)}}),
        ("c2x_res_jac/solve_adjoint",): (
            lambda: cpiga2xi.c2x_solve_adjoint(ss, p, q, mi, cp, x, g),
            lambda: cpiga2xi._adjoint_plain(ss, p, q, mi, cp, x, g),
            ops["solve_adjoint"][0], fixed + [cp, x, g],
            {"flops_dual": ops["solve_adjoint"][1],
             "also": {"composed": lambda: cpiga2xi._adjoint_composed(
                 ss, p, q, mi, cp, x, g)}}),
    }


def c7_reproducible(sys_, runs=5):
    """[kernel C2] K7's solved adjoint (and mode 1) sum without atomics:
    dcp must be the same, bit for bit, over `runs` launches."""
    from goldfish_tpu_torch.geometry import cpiga2xi

    cp, _, xi, _, _ = mi_state(sys_)
    mi, ss, p, q = sys_.mi, sys_.ss, sys_.pdeg, sys_.qdeg
    g = torch.tensor(np.random.default_rng(2).normal(
        size=tuple(xi.shape)), device=cp.device)
    for name, fn in (("solve_adjoint", cpiga2xi.c2x_solve_adjoint),
                     ("adjoint", cpiga2xi.c2x_res_vjp)):
        outs = [fn(ss, p, q, mi, cp, xi, g) for _ in range(runs)]
        same = all(torch.equal(o, outs[0]) for o in outs[1:])
        say(f"[kernel C2] c2x adjoint c2x_res_jac/{name}: dcp over {runs} "
            f"launches bit-identical {same}")
        if not same:
            raise RuntimeError(f"c2x_res_jac/{name}: dcp changes from "
                               f"launch to launch")


def k6_reproducible(sys_, runs=5):
    """[kernel C2] K6 writes each output once a point (no atomics): its
    output must be the same, bit for bit, over `runs` launches."""
    from goldfish_tpu_torch.physics import coupling_mi

    cp, h, xi, d, lam = mi_state(sys_)
    mi = sys_.mi
    x4 = xi.reshape(mi.n_int, mi.n_max, 2, 2).contiguous()
    tA = coupling_mi._curve_tangents(x4[:, :, 0], mi.n_pts).contiguous()
    tB = coupling_mi._curve_tangents(x4[:, :, 1], mi.n_pts).contiguous()
    outs = [coupling_mi.mi_penalty_xi(sys_.ss, sys_.pdeg, sys_.qdeg, mi,
                                      sys_.co, x4, tA, tB, d, cp, h,
                                      sys_.data.E, lam) for _ in range(runs)]
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    say(f"[kernel C2] mi_penalty_xi: out over {runs} launches bit-identical "
        f"{same}")
    if not same:
        raise RuntimeError("mi_penalty_xi: its output changes from launch "
                           "to launch")


def mi_kernel_cases(sys_, edge=True, label="mi-kernel"):
    """(name, case...) -> (kernel fn, plain fn, flops, inputs) of an MI
    system; the first case of each name is the one the MI path runs.
    `edge` adds K7's edge-to-edge variant on a synthetic seam (for a system
    whose own seams do not take it); `label` prefixes the printed lines."""
    from goldfish_tpu_torch.geometry import cpiga2xi
    from goldfish_tpu_torch.ops import bspline_traced as bt
    from goldfish_tpu_torch.physics import coupling_mi
    from goldfish_tpu_torch.solver import system, system_mi

    cp, h, xi, d, lam = mi_state(sys_)
    mi, co, ss, p, q = sys_.mi, sys_.co, sys_.ss, sys_.pdeg, sys_.qdeg
    data = sys_.data
    I, N = mi.n_int, mi.n_max
    L = (p + 1) * (q + 1)

    def pts_of(x):
        x4 = x.reshape(I, N, 2, 2)
        ip = torch.cat([mi.pairA[:, None].expand(I, N).reshape(-1),
                        mi.pairB[:, None].expand(I, N).reshape(-1)])
        return ip.contiguous(), \
            x4.permute(2, 0, 1, 3).reshape(-1, 2).contiguous()

    ip, pts = pts_of(xi)
    ip0, pts0 = pts_of(sys_.c2x.xi0_flat)
    M = ip.shape[0]

    E = data.E
    gx = torch.tensor(np.random.default_rng(2).normal(size=(I, 4 * N)),
                      device=cp.device)
    st = data.stack
    sv = [ss.knots_u, ss.knots_v, ss.span_u_vals, ss.span_u_ids,
          ss.span_v_vals, ss.span_v_ids, ss.w, ss.n_v]
    mi_in = [mi.pairA, mi.pairB, mi.n_pts, mi.end_dir, mi.end_val, mi.xi0,
             mi.both_edges, mi.epin_dir, mi.epin_val]
    cases = {}
    for tag, (ipx, ptx) in (("moved", (ip, pts)), ("on-knot", (ip0, pts0))):
        cases[("traced_rows", tag)] = rows_case(ss, p, q, ipx, ptx)
    for tag, x in (((), xi), (("on-knot",), sys_.c2x.xi0_flat)):
        x4 = x.reshape(I, N, 2, 2).contiguous()
        tA = coupling_mi._curve_tangents(x4[:, :, 0], mi.n_pts).contiguous()
        tB = coupling_mi._curve_tangents(x4[:, :, 1], mi.n_pts).contiguous()
        args = (ss, p, q, mi, co, x4, tA, tB, d, cp, h, E, lam)
        cases[("mi_penalty_xi",) + tag] = (
            lambda a=args: coupling_mi.mi_penalty_xi(*a),
            lambda a=args: coupling_mi._xi_grad_plain(*a),
            k6_ops(I, N, L), sv + [x4, tA, tB, co.w_s, d, cp, h, lam],
            {"flops_dual": I * N * (2 * BASIS_OPS * 9 + 2 * L * 6 * 9 * 3
                                    + 18 * DENS_PEN)})
    # K6 mode 1, the xi-forward tangent of r_pen along a seeded txi
    tx = torch.tensor(np.random.default_rng(3).normal(size=(I, 4 * N)),
                      device=cp.device)
    x4 = xi.reshape(I, N, 2, 2).contiguous()
    t4 = tx.reshape(I, N, 2, 2).contiguous()
    tg = [coupling_mi._curve_tangents(x[:, :, k], mi.n_pts).contiguous()
          for x in (x4, t4) for k in (0, 1)]
    fwd_args = (ss, p, q, mi, co, x4, tg[0], tg[1], d, cp, h, E, t4, tg[2],
                tg[3])
    cases[("mi_penalty_xi/xi_fwd",)] = (
        lambda: coupling_mi.mi_penalty_xi_fwd(*fwd_args),
        lambda: coupling_mi._xi_fwd_plain(*fwd_args),
        k6_fwd_ops(I, N, L), sv + [x4, t4, *tg, co.w_s, d, cp, h])
    ops = k7_ops(I, N, L)
    tcp = torch.tensor(np.random.default_rng(5).normal(size=tuple(cp.shape)),
                       device=cp.device)
    cases[("c2x_res_jac/cp_fwd",)] = (
        lambda: cpiga2xi.c2x_res_jvp(ss, p, q, mi, cp, xi, tcp),
        lambda: cpiga2xi._res_jvp_plain(ss, p, q, mi, cp, xi, tcp),
        ops["adjoint"][0], sv + mi_in + [cp, xi, tcp])
    cases[("c2x_res_jac/res_jac",)] = (
        lambda: cpiga2xi.c2x_res_jac(ss, p, q, mi, cp, xi),
        lambda: cpiga2xi._res_jac_plain(ss, p, q, mi, cp, xi, True),
        ops["res_jac"][0], sv + mi_in + [cp, xi],
        {"flops_dual": ops["res_jac"][1]})
    cases[("c2x_res_jac/adjoint",)] = (
        lambda: cpiga2xi.c2x_res_vjp(ss, p, q, mi, cp, xi, gx),
        lambda: cpiga2xi._res_vjp_plain(ss, p, q, mi, cp, xi, gx),
        ops["adjoint"][0], sv + mi_in + [cp, xi, gx],
        {"flops_dual": ops["adjoint"][1]})
    cases.update(fused_cases(ss, p, q, mi, cp, xi, gx, sv + mi_in))
    if edge:
        # K7's edge-to-edge variant, which the T-beam's seam does not take:
        # two flat patches side by side, seam along A's u = 1 and B's u = 0
        ex, ecp, ex_x, eg = edge_seam(cp.device)
        e_in = [ex.mi.pairA, ex.mi.pairB, ex.mi.n_pts, ex.mi.end_dir,
                ex.mi.end_val, ex.mi.xi0, ex.mi.both_edges, ex.mi.epin_dir,
                ex.mi.epin_val, ecp, ex_x]
        cases[("c2x_res_jac/res_jac", "edge")] = (
            lambda: cpiga2xi.c2x_res_jac(ex.ss, p, q, ex.mi, ecp, ex_x),
            lambda: cpiga2xi._res_jac_plain(ex.ss, p, q, ex.mi, ecp, ex_x,
                                            True),
            0, e_in)
        cases[("c2x_res_jac/adjoint", "edge")] = (
            lambda: cpiga2xi.c2x_res_vjp(ex.ss, p, q, ex.mi, ecp, ex_x, eg),
            lambda: cpiga2xi._res_vjp_plain(ex.ss, p, q, ex.mi, ecp, ex_x,
                                            eg),
            0, e_in + [eg])
        etcp = torch.tensor(np.random.default_rng(6).normal(
            size=tuple(ecp.shape)), device=ecp.device)
        cases[("c2x_res_jac/cp_fwd", "edge")] = (
            lambda: cpiga2xi.c2x_res_jvp(ex.ss, p, q, ex.mi, ecp, ex_x, etcp),
            lambda: cpiga2xi._res_jvp_plain(ex.ss, p, q, ex.mi, ecp, ex_x,
                                            etcp),
            0, e_in + [etcp])
        cases.update({k + ("edge",): v for k, v in fused_cases(
            ex.ss, p, q, ex.mi, ecp, ex_x, eg, e_in[:-2]).items()})
    cases[("shell_qp/geom_grad",)] = geom_grad_case(st, d, cp, h, E, data.nu)
    # K1-K4 as the MI path runs them: the T-beam stack, the interface stack
    # of K5's rows at xi, the full MI tangent. At the coupled response d
    # the displacement jump across the seam nearly cancels and K2's value
    # and gradient are ill-conditioned in d (`seam_conditioning`), so, as
    # for the wing, d gets seeded noise (1e-3 of its largest entry)
    dx = system_mi.data_at(data, mi, co, ss, p, q, xi)
    rng = np.random.default_rng(4)
    T = lambda a: torch.tensor(a, device=cp.device)  # noqa
    dn = d + T(1e-3 * float(d.abs().max())
               * rng.normal(size=tuple(cp.shape))) * data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    for name, case in fixed_cases(dx, dn, cp, h, lam, v, label).items():
        cases[(name, "mi")] = case
    # K3 through the Woodbury seam-slot map: every dof outside the seam
    # subspace lands in one padding slot whose free entry is 0
    fac = system_mi.PersistentDeviceFactorMI(*sys_.mi_args)
    fac.ensure(cp, h, xi, d, force=True, why="smoke")
    H_i, tab = fac._interface_hessians((cp, h, xi, d))
    k3_runs(label + " seam-slots",
            [("interface", fac._slot[tab.gi_i.long()])], fac._free_m)
    cases[("jet_assemble", "seam-slots")] = (
        lambda: fac._compact_K(H_i, tab),
        lambda: fac._compact_K(H_i, tab, system._assemble_plain),
        assemble_ops(tab.R_i), [H_i, tab.R_i, tab.gi_i, fac._free_m])
    return cases


def seam_conditioning(sys_):
    """Printed, not gated: K2 mode a at the coupled response d, kernel vs
    plain, beside the plain version's own change when d moves by one ulp
    (relative). The displacement jump across the seam nearly cancels
    there, so two correct f64 evaluations differ by about the latter."""
    from goldfish_tpu_torch.physics import coupling
    from goldfish_tpu_torch.solver import system_mi

    cp, h, xi, d, _ = mi_state(sys_)
    ifs = system_mi.data_at(*sys_.mi_args, xi).ifs
    E = sys_.data.E
    ulp = 1.0 + 2.2e-16 * torch.tensor(
        np.random.default_rng(5).choice([-1.0, 1.0], size=tuple(d.shape)),
        device=d.device)
    plain = coupling._value_grad_plain(ifs, d, cp, h, E)

    def worst(a):
        return max(rel_err(x, y)[0] for x, y in zip(a, plain)
                   if x is not None)

    k = worst(coupling.penalty_value_grad(ifs, d, cp, h, E))
    u = worst(coupling._value_grad_plain(ifs, d * ulp, cp, h, E))
    say(f"[mi-kernel coupled-d] penalty_qp/value_grad kernel vs plain rel "
        f"{k:.3e}; plain vs plain at d moved by one ulp rel {u:.3e} "
        f"(not gated)")


def merge(checks, name, got, suffix=None):
    """Merge one checked case into `checks`: a kernel keeps the worst error
    over its cases and the times of its first case; a case with a suffix
    adds its times as <key>_<suffix>."""
    prev = checks.get(name)
    if prev is None:
        checks[name] = got
        return
    prev["rel"] = max(got["rel"], prev["rel"])
    prev["max_abs_err"] = max(got["max_abs_err"], prev["max_abs_err"])
    if suffix:
        prev.update({f"{k}_{suffix}": got[k] for k in got
                     if k in ("ms", "plain_ms", "bound_ms")
                     or k.startswith(("ms_", "bound_ms_"))})


def phase_mi_kernels(sys_, checks, reps=5, system="mi"):
    """Check every MI case of `sys_` and merge it into `checks`. On the
    T-beam (`system` "mi") the MI path's case of K1-K4 adds its times as
    *_mi; on another system ("tube", "evtol") those add *_<system>_mi and
    K5-K7's own cases *_<system>."""
    seam_conditioning(sys_)
    tbeam_ = system == "mi"
    tag = "mi-kernel" if tbeam_ else f"{system}-mi-kernel"
    for key, case in mi_kernel_cases(sys_, edge=tbeam_, label=tag).items():
        name = key[0]
        got = check_kernels({name: case}, tag + " " + "/".join(
            str(k) for k in key[1:]), reps, tol=FUSED_TOL)[name]
        suffix = None
        if key[1:] == ("mi",):
            suffix = "mi" if tbeam_ else f"{system}_mi"
        elif not tbeam_ and key[1:] in ((), ("moved",)):
            suffix = system
        merge(checks, name, got, suffix)
    if tbeam_:
        c7_reproducible(sys_)
        k6_reproducible(sys_)
    return checks


def mi_bend(sys_, dev):
    """bench_mi.py's design direction: sin(pi v) on the web's x."""
    m = sys_.metas[1]
    gv = sys_.surfs[1].greville_points(1)
    return torch.tensor(np.tile(np.sin(np.pi * gv)[None, :],
                                (m.n_u, 1)).ravel(), device=dev)


def mi_solve_nonlinear_check(sys_, dev, amp=0.05):
    """ROADMAP Queue C1: the MI system's own `solve_nonlinear` (xi =
    c2x.solve(cp), then the MI Newton at xi) against `build_forward`'s
    coupled solve at the same design (rel <= 1e-8), with u_z at the
    loaded corner."""
    m = sys_.metas[1]
    cp = sys_.cp.clone()
    cp[1, : m.n_cp, 0] += amp * mi_bend(sys_, dev)
    t0 = time.perf_counter()
    d_sn = sys_.solve_nonlinear(cp=cp, rtol=1e-10)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with torch.no_grad():
        d_fw, _ = sys_.build_forward(rtol=1e-10)(cp, sys_.h_init,
                                                 sys_.zero_displacement())
    e = rel_err(d_sn, d_fw)[0]
    uz = sys_.evaluate_displacement(d_sn, 0, [1.0, 1.0])[2]
    say(f"[mi C1] solve_nonlinear vs build_forward at amp={amp}: rel "
        f"{e:.3e} (gate 1e-8), u_z(1, 1) = {uz!r}, {dt:.3f} s")
    if not (e <= 1e-8 and abs(uz) > 0.0):
        raise RuntimeError(f"MINonMatchingSystem.solve_nonlinear is not the "
                           f"coupled MI solve: rel {e:.3e}, u_z {uz!r}")


def make_mi_iteration(sys_, dev):
    """bench_mi.py's opt_iteration on the port: returns (iteration,
    forward); iteration(amp, d0, xi_seed) -> (J, dJ/damp, d, xi, wall)."""
    from goldfish_tpu_torch.physics import kl_shell

    m = sys_.metas[1]
    bend = mi_bend(sys_, dev)
    forward = sys_.build_forward(rtol=1e-9, max_it=30)
    h = sys_.h_init
    xi_start = sys_.c2x.xi0_flat

    def iteration(amp_v, d0, xi_seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amp = torch.tensor(amp_v, dtype=torch.float64, device=dev,
                           requires_grad=True)
        cp = sys_.cp.clone()
        cp[1, : m.n_cp, 0] = cp[1, : m.n_cp, 0] + amp * bend
        d, xi = forward(cp, h, d0, xi_seed)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        J.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        J, g = float(J.detach()), float(amp.grad)
        d, xi = d.detach(), xi.detach()
        if not (np.isfinite(J) and np.isfinite(g)
                and bool(torch.isfinite(d).all())
                and bool(torch.isfinite(xi).all())
                and d.shape == sys_.cp.shape and xi.shape == xi_start.shape):
            raise RuntimeError("non-finite or misshapen MI iteration output")
        return J, g, d, xi, dt

    return iteration, forward


def phase_mi_main(sys_, dev):
    """bench_mi.py's iteration: cold at amp = 0.05, then 5 warm steps."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart

    with open(REF_MI) as fh:
        ref = json.load(fh)
    iteration, forward = make_mi_iteration(sys_, dev)
    fac = forward.solve_d.device_factor
    xi_start = sys_.c2x.xi0_flat
    reset_counts()
    J, g, d, xi, t_cold = iteration(0.05, sys_.zero_displacement(), None)
    eJ = abs(J - ref["J"]) / abs(ref["J"])
    eg = abs(g - ref["dJ_damp"]) / abs(ref["dJ_damp"])
    say(f"[mi] cold iteration {t_cold:.3f} s  J={J!r} (ref {ref['J']!r}, "
        f"rel {eJ:.2e})  dJ/damp={g!r} (ref {ref['dJ_damp']!r}, rel "
        f"{eg:.2e})  |d|={float(torch.linalg.norm(d))!r} (ref "
        f"{ref['d_norm']!r})  |xi-xi0|="
        f"{float(torch.linalg.norm(xi - xi_start))!r} (ref "
        f"{ref['xi_shift_norm']!r})  newton its "
        f"{forward.solve_d.solver.last_its}, xi-newton its "
        f"{sys_.c2x.last_its}")
    if not (eJ <= 1e-8 and eg <= 1e-6):
        raise RuntimeError(f"MI cold iteration disagrees with the JAX CPU "
                           f"reference: J rel {eJ:.2e}, dJ/damp rel "
                           f"{eg:.2e}")
    ws_d, ws_xi = SecantWarmStart(), SecantWarmStart()
    a0 = torch.tensor(0.05, dtype=torch.float64)
    ws_d.update(a0, d)
    ws_xi.update(a0, xi)
    warm = []
    for k in range(1, 6):
        amp = 0.05 * (1.0 + 1e-3 * k)
        ak = torch.tensor(amp, dtype=torch.float64)
        seed = ws_xi.predict(ak, xi).clamp(0.0, 1.0)
        J, g, d, xi, dt = iteration(amp, ws_d.predict(ak, d), seed)
        ws_d.update(ak, d)
        ws_xi.update(ak, xi)
        warm.append(dt)
        say(f"[mi] warm iteration {k}/5 {dt:.3f} s J={J!r} dJ/damp={g!r} "
            f"newton its {forward.solve_d.solver.last_its} xi-newton its "
            f"{sys_.c2x.last_its}")
    counts = dict(_cuda.launch_counts)
    say_shapes("mi")
    say(f"[mi] warm median {float(np.median(warm)):.3f} s; n_factor "
        f"{fac.n_factor} (failed {fac.n_factor_failed}); seam subspace M "
        f"{fac._M}")
    say(f"[mi] refactor_log {fac.refactor_log}")
    say(f"[mi] cert_log tail {fac.cert_log[-16:]}")
    say(f"[mi] launch counts {counts}")
    say_route("mi", sys_.c2x, counts)
    missing = [k for k in MI_PATH_KERNELS + CHOL + ("chol_subst/multi",)
               if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the MI path: "
                           f"{missing}")
    mi_solve_nonlinear_check(sys_, dev)
    return counts, fac


# ------------------------------------------------------------ tube
def tube_state(sys_, seed=6):
    """A seeded state of a pressurized tube on the card: (cp, h, d, lam, v)
    with d the linear response to the pressure plus seeded noise (1e-3 of
    its largest entry) on free dofs, lam and v random."""
    from goldfish_tpu_torch.solver import system

    data = sys_.data
    dev = sys_.cp.device
    rng = np.random.default_rng(seed)
    cp, h = sys_.cp, sys_.h_init
    zero = torch.zeros_like(cp)
    K0 = system.assemble_K(data, zero, cp, h)
    r0 = system.residual(data, zero, cp, h)
    d = torch.linalg.solve(K0, -r0.reshape(-1)).reshape(cp.shape)
    del K0
    T = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    d = d + T(1e-3 * float(d.abs().max())
              * rng.normal(size=tuple(cp.shape))) * data.free
    lam = T(rng.normal(size=tuple(cp.shape))) * data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    return cp, h, d, lam, v


def time_library(tag, fac, c2x=None, reps=3):
    """The library calls of a path at its size, with CUDA events: potrf
    (`cholesky_ex` of the equilibrated K at the factor's reference state,
    K14's yardstick), K14 at that K (`phase_k14`), K13 on K14's factor
    against `cholesky_solve` and the rest (`phase_k13`), and on an MI path
    the Woodbury capacitance `linalg.solve` (M x M, M right-hand sides) and
    the batched xi `linalg.solve` (I systems of 4N). Bounds: potrf N^3/3
    and LU 2M^3/3 + 2M^3 (M right-hand sides) f64 operations over the f64
    tensor-core rate; the xi solves the larger of their operations and
    bytes."""
    K = fac._assemble(fac._ref)
    dsc = torch.rsqrt(K.diagonal().abs() + 1e-300)
    K.mul_(dsc[:, None]).mul_(dsc[None, :])
    N = K.shape[0]
    with library_calls():
        info = torch.linalg.cholesky_ex(K)[1]
        rows = [dict(name="cholesky_ex", path=tag, n=N, info=int(info),
                     ms=cuda_ms(lambda: torch.linalg.cholesky_ex(K), reps),
                     bound_ms=N ** 3 / 3 / PEAK_F64_TC * 1e3,
                     bound_by="operations")]
    L, invs = phase_k14(tag, K)
    phase_k13(tag, K, L, dsc, invs, fac)
    dev = L.device
    del K, L, invs
    M = getattr(fac, "_M", None)
    if M:
        g = torch.Generator(device="cpu").manual_seed(7)
        Cm = (torch.eye(M, dtype=torch.float64) + 0.01 * torch.randn(
            M, M, dtype=torch.float64, generator=g) / M ** 0.5).to(dev)
        B = torch.randn(M, M, dtype=torch.float64, generator=g).to(dev)
        rows.append(dict(name="capacitance linalg.solve", path=tag, n=M,
                         ms=cuda_ms(lambda: torch.linalg.solve(Cm, B), reps),
                         bound_ms=(2 * M ** 3 / 3 + 2 * M ** 3) / PEAK_F64_TC
                         * 1e3, bound_by="operations"))
    if c2x is not None:
        from goldfish_tpu_torch.geometry import cpiga2xi

        r, J = cpiga2xi.c2x_res_jac(c2x.ss, c2x.p, c2x.q, c2x.mi, fac._ref[0],
                                    c2x.xi0_flat)
        I_, n = J.shape[0], J.shape[-1]
        bb, by = bound(I_ * (n * n + 2 * n) * 8,
                       I_ * (2 * n ** 3 / 3 + 2 * n * n))
        rows.append(dict(name="xi batched linalg.solve", path=tag,
                         n=f"{I_}x{n}",
                         ms=cuda_ms(lambda: torch.linalg.solve(
                             J, -r[..., None]), 10),
                         bound_ms=bb, bound_by=by))
    for row in rows:
        say(f"[library] {json.dumps(row)}")
    return rows


# ------------------------------------------------------------ K13, K14
_CHOLESKY_SOLVE = torch.cholesky_solve
_CHOLESKY_EX = torch.linalg.cholesky_ex
_LIBRARY = [0]


class library_calls:
    """Inside: torch.cholesky_solve and torch.linalg.cholesky_ex may run on
    CUDA tensors (the smoke's yardsticks and K13's and K14's plain
    versions); outside, the guards raise."""

    def __enter__(self):
        _LIBRARY[0] += 1

    def __exit__(self, *exc):
        _LIBRARY[0] -= 1


def guard_cholesky_solve():
    """From here on a torch.cholesky_solve on a CUDA tensor outside
    `library_calls` raises: the port's main paths solve on K13 only."""

    def guarded(B, L, *args, **kw):
        if (B.is_cuda or L.is_cuda) and not _LIBRARY[0]:
            raise RuntimeError("torch.cholesky_solve ran on a CUDA tensor "
                               "on a main path: K13 must take every "
                               "Cholesky solve")
        return _CHOLESKY_SOLVE(B, L, *args, **kw)

    torch.cholesky_solve = guarded


def guard_cholesky_ex():
    """From here on a torch.linalg.cholesky_ex on a CUDA tensor outside
    `library_calls` raises: the port's main paths factor on K14 only."""

    def guarded(A, *args, **kw):
        if A.is_cuda and not _LIBRARY[0]:
            raise RuntimeError("torch.linalg.cholesky_ex ran on a CUDA "
                               "tensor on a main path: K14 must take every "
                               "Cholesky factorization")
        return _CHOLESKY_EX(A, *args, **kw)

    torch.linalg.cholesky_ex = guarded


# K13's checks over the factors (the first, wing20's, gives the kernels
# line's times; the others add theirs as *_<path>), and the phase's seconds
K13 = {}
K13_SECONDS = [0.0]
K13_BWD = 4.0    # backward error of the kernel <= K13_BWD x the plain's
K13_WELL = 1e-12  # kernel vs plain at a well-conditioned SPD matrix
# K14's checks over the factors (the first, wing20's, gives the kernels
# line's times; the others add theirs as *_<path>), and the phase's seconds
K14 = {}
K14_SECONDS = [0.0]
# what a path that factors and solves by Cholesky on the card must launch:
# K14's factor and K13's one-column substitution
CHOL = ("chol_subst/vec", "chol_factor")


def chol_needed(counts):
    """The K13 and K14 launches a counted path must show: every path that
    made a Cholesky factor on the card (K14 ran, or K13's inverses) must
    have made it with K14 and solved on it through K13."""
    made = counts.get("chol_factor") or counts.get("chol_subst/diag_inv")
    return CHOL if made else ()


def bwd_err(K, X, B, nK):
    """||K X - B|| / (||K|| ||X||), Frobenius norms (nK = ||K||)."""
    return float(torch.linalg.norm(K @ X - B) / (nK * torch.linalg.norm(X)))


def fac_bwd(K, L, nK):
    """||K - L L^T|| / ||K||, Frobenius norms (nK = ||K||)."""
    return float(torch.linalg.norm(K - L @ L.T) / nK)


def inv_bwd_of(L, NB):
    """The inverses' backward error ||L_kk Z_k^T - I|| / (||L_kk|| ||Z_k||)
    over L's full NB-row diagonal blocks, as a function of Z (nblk, NB,
    NB) laid out as `diag_inverses` returns it."""
    N = L.shape[0]
    nb = -(-N // NB)
    if nb < 2:
        return lambda Z: 0.0
    blocks = torch.stack([L[k * NB:(k + 1) * NB, k * NB:(k + 1) * NB]
                          for k in range(nb - 1)])
    eye = torch.eye(NB, dtype=L.dtype, device=L.device)

    def bwd(Z):
        Zt = Z[:nb - 1].transpose(1, 2)
        return float(torch.linalg.norm(blocks @ Zt - eye)
                     / (torch.linalg.norm(blocks) * torch.linalg.norm(Zt)))

    return bwd


def chol_factor_ms(K, reps):
    """Median device time of K14 on a fresh copy of K (the kernel factors
    in place), the copy made and the L2 flushed outside the timed window
    (CUDA events)."""
    from goldfish_tpu_torch.solver import cholesky as ch

    if not _FLUSH:
        _FLUSH.append(torch.empty(2 ** 25, dtype=torch.float64,
                                  device="cuda"))
    buf = torch.empty_like(K)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps + 1):
        buf.copy_(K)
        _FLUSH[0].fill_(1.0)
        t0.record()
        ch.chol_factor(buf)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times[1:]))


def peak_mb(fn):
    """Device memory fn() allocates at its peak beyond what was allocated
    before it (MB), its results freed after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 1e6


def phase_k14(tag, K, reps=5):
    """K14 at one path's equilibrated tangent K (left as it is: K14 runs on
    copies) against `cholesky_ex` on the same K. Gates: the factor's
    backward error ||K - L L^T|| / ||K|| <= K13_BWD x cholesky_ex's; the
    same bits (L, info, invs) over two launches; `info` equal to
    cholesky_ex's, at K and at K with one diagonal entry negated (the
    order of the first leading minor that is not positive definite); at a
    well-conditioned SPD matrix of the same N (A A^T / N + I, A seeded) L
    within K13_WELL of cholesky_ex's; K14's diagonal inverses against
    `diag_inverses(L)` of its own factor: the backward error <= K13_BWD x
    theirs, the relative difference printed. Times with the L2 flushed
    before each launch (CUDA events, median of `reps`): the kernel, its
    plain version (`cholesky_ex` and `diag_inverses_plain`) and
    `cholesky_ex` alone (the library call, its copy of K included); the
    peak memory of one factorization beside cholesky_ex's. Returns K14's
    (L, invs) at K, on which phase_k13 checks K13."""
    from goldfish_tpu_torch.solver import cholesky as ch

    t0 = time.perf_counter()
    N = K.shape[0]
    dev = K.device
    nK = torch.linalg.norm(K)
    runs = [ch.chol_factor(K.clone()) for _ in range(2)]
    torch.cuda.synchronize()
    (L, info, invs), (L2, info2, invs2) = runs
    same = torch.equal(L, L2) and torch.equal(invs, invs2) and \
        int(info) == int(info2)
    del runs, L2, invs2
    with library_calls():
        Lx, info_x = torch.linalg.cholesky_ex(K)
    e_k, e_x = fac_bwd(K, L, nK), fac_bwd(K, Lx, nK)
    rel, mx = rel_err(L, Lx)
    del Lx
    # info where a leading minor is not positive definite
    j = N // 2 + 7
    Kj = K.clone()
    Kj[j, j] = -Kj[j, j]
    with library_calls():
        info_xj = int(torch.linalg.cholesky_ex(Kj)[1])
    info_j = int(ch.chol_factor(Kj)[1])
    del Kj
    # the diagonal blocks' inverses against K13's of the same factor
    inv_bwd = inv_bwd_of(L, ch.NB)
    Z = ch.diag_inverses(L)
    ei_k, ei_z = inv_bwd(invs), inv_bwd(Z)
    rel_inv = rel_err(invs, Z)[0]
    del Z
    # a well-conditioned SPD matrix of the same N
    g = torch.Generator(device="cpu").manual_seed(N + 14)
    A = torch.randn(N, N, dtype=torch.float64, generator=g).to(dev)
    Kw = A @ A.T / N + torch.eye(N, dtype=torch.float64, device=dev)
    del A
    with library_calls():
        Lwx = torch.linalg.cholesky_ex(Kw)[0]
    ew = rel_err(ch.chol_factor(Kw)[0], Lwx)[0]
    del Kw, Lwx
    torch.cuda.empty_cache()
    # times and memory
    got = dict(rel=rel, max_abs_err=mx, bwd=e_k, bwd_library=e_x,
               bwd_ratio=e_k / e_x, ms=chol_factor_ms(K, reps))
    with library_calls():
        got["plain_ms"] = cuda_ms_cold(lambda: ch.chol_factor_plain(K), 2)
        got["library_ms"] = cuda_ms_cold(
            lambda: torch.linalg.cholesky_ex(K), reps)
        mb_x = peak_mb(lambda: torch.linalg.cholesky_ex(K))
    B = K.clone()
    mb_k = peak_mb(lambda: ch.chol_factor(B))
    del B
    got["ms_cholesky_ex"] = got["library_ms"]
    got["bound_ms"], got["bound_by"] = bound(
        8 * (N * (N + 1) + invs.numel()), N ** 3 / 3, PEAK_F64_TC)
    got["peak_mb"], got["peak_mb_cholesky_ex"] = mb_k, mb_x
    say(f"[k14 {tag}] N={N}: backward error {e_k:.3e} (cholesky_ex "
        f"{e_x:.3e}, ratio {e_k / e_x:.2f}); L rel {rel:.3e}; same bits "
        f"over two launches {same}; info {int(info)} (cholesky_ex "
        f"{int(info_x)}), with K[{j},{j}] negated {info_j} ({info_xj}); "
        f"well-conditioned rel {ew:.3e} (gate {K13_WELL:g}); invs backward "
        f"error {ei_k:.3e} (diag_inverses {ei_z:.3e}), rel {rel_inv:.3e}")
    say(f"[k14 {tag}] kernel {got['ms']:.3f} ms plain {got['plain_ms']:.3f} "
        f"ms cholesky_ex {got['library_ms']:.3f} ms bound "
        f"{got['bound_ms']:.3f} ms ({got['bound_by']}); peak memory of one "
        f"factorization {mb_k:.1f} MB (cholesky_ex {mb_x:.1f} MB)")
    bad = []
    if not e_k <= K13_BWD * e_x:
        bad.append(f"backward error {e_k:.3e} > {K13_BWD:g} x {e_x:.3e}")
    if not same:
        bad.append("two launches differ")
    if int(info) != int(info_x) or info_j != info_xj or info_j != j + 1:
        bad.append(f"info {int(info)} / {info_j}, cholesky_ex "
                   f"{int(info_x)} / {info_xj}")
    if not ew <= K13_WELL:
        bad.append(f"well-conditioned rel {ew:.3e}")
    if not ei_k <= K13_BWD * ei_z + 1e-300:
        bad.append(f"invs backward error {ei_k:.3e} > {K13_BWD:g} x "
                   f"{ei_z:.3e}")
    if bad:
        raise RuntimeError(f"K14 {tag}: " + "; ".join(bad))
    merge(K14, "chol_factor", got, tag if K14 else None)
    torch.cuda.empty_cache()
    K14_SECONDS[0] += time.perf_counter() - t0
    say(f"[k14 {tag}] {time.perf_counter() - t0:.1f} s (phase so far "
        f"{K14_SECONDS[0]:.1f} s)")
    return L, invs


def phase_k13(tag, K, L, dsc, invs14, fac, reps=5):
    """K13 at one path's factor (K the equilibrated tangent, L and invs14
    its K14 factor and diagonal inverses, as the main paths make them): the
    diagonal blocks' inverses of L (`diag_inverses`), one column at three
    seeded right-hand sides, and at an MI factor the Woodbury basis (N x M
    one-hot), each against its plain version, the solves on invs14. Gates:
    the backward error of the equilibrated system ||K x - b|| / (||K||
    ||x||) (the inverses': ||L_kk Z - I|| / (||L_kk|| ||Z||) over the
    blocks) <= K13_BWD x the plain version's; the same bits over two
    launches; and at a well-conditioned SPD matrix of the same N (A A^T /
    N + I, A seeded, factored by K14) the kernel within K13_WELL of the
    plain version. Times with the L2 flushed before each launch (CUDA
    events, median of `reps`):
    the kernel, the plain version, `cholesky_solve` (its copy of the
    factor included) and the `solve_triangular` pair, the library route
    without the copy; none of them runs on a main path."""
    from goldfish_tpu_torch.solver import cholesky as ch

    t0 = time.perf_counter()
    N = K.shape[0]
    dev = K.device
    nK = torch.linalg.norm(K)
    g = torch.Generator(device="cpu").manual_seed(N)

    def pair(B):
        y = torch.linalg.solve_triangular(L, B, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)

    def bits(fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise RuntimeError(f"K13 {tag}: two launches differ")
        return a

    # the diagonal blocks' inverses
    invs = bits(lambda: ch.diag_inverses(L))
    plain = ch.diag_inverses_plain(L)
    nb = invs.shape[0]
    blocks = torch.stack([L[k * ch.NB:(k + 1) * ch.NB,
                            k * ch.NB:(k + 1) * ch.NB] for k in
                          range(nb - 1)]) if nb > 1 else None
    eye = torch.eye(ch.NB, dtype=L.dtype, device=dev).expand(
        max(nb - 1, 1), ch.NB, ch.NB)
    inv_bwd = inv_bwd_of(L, ch.NB)
    e_k, e_p = inv_bwd(invs), inv_bwd(plain)
    rel, mx = rel_err(invs, plain)
    got = dict(rel=rel, max_abs_err=mx, bwd=e_k, bwd_plain=e_p,
               ms=cuda_ms_cold(lambda: ch.diag_inverses(L), reps),
               plain_ms=cuda_ms_cold(lambda: ch.diag_inverses_plain(L), 2),
               library_ms=(cuda_ms_cold(lambda: torch.linalg.solve_triangular(
                   blocks, eye, upper=False), reps)
                   if blocks is not None else None))
    got["ms_solve_triangular"] = got["library_ms"] or 0.0
    tri = nb * ch.NB * (ch.NB + 1) // 2
    got["bound_ms"], got["bound_by"] = bound(
        8 * (tri + nb * ch.NB * ch.NB), nb * ch.NB ** 3 / 3)
    say(f"[k13 {tag}] diag_inv rel {rel:.3e} backward error {e_k:.3e} "
        f"(plain {e_p:.3e}) kernel {got['ms']:.4f} ms plain "
        f"{got['plain_ms']:.4f} ms solve_triangular "
        f"{got['library_ms'] or 0.0:.4f} ms bound {got['bound_ms']:.4f} ms "
        f"({got['bound_by']})")
    if not e_k <= K13_BWD * e_p + 1e-300:
        raise RuntimeError(f"K13 {tag}: diag_inv backward error {e_k:.3e} "
                           f"> {K13_BWD:g} x {e_p:.3e}")
    merge(K13, "chol_subst/diag_inv", got, tag if K13 else None)
    del plain, blocks, eye
    invs = invs14   # the solves take the main paths' inverses: K14's

    # one column: three seeded right-hand sides
    ratios, mx = [], 0.0
    with library_calls():
        for i in range(3):
            b = torch.randn(N, 1, dtype=torch.float64, generator=g).to(dev)
            x = bits(lambda: ch.chol_solve(L, dsc, b, invs))
            xp = ch.chol_solve_plain(L, dsc, b)
            ek, ep = bwd_err(K, x / dsc[:, None], dsc[:, None] * b, nK), \
                bwd_err(K, xp / dsc[:, None], dsc[:, None] * b, nK)
            ratios.append(ek / ep)
            mx = max(mx, rel_err(x, xp)[1])
            say(f"[k13 {tag}] vec b{i}: backward error {ek:.3e} (plain "
                f"{ep:.3e}, ratio {ek / ep:.2f}); x rel "
                f"{rel_err(x, xp)[0]:.3e}")
            if not ek <= K13_BWD * ep:
                raise RuntimeError(f"K13 {tag}: backward error {ek:.3e} > "
                                   f"{K13_BWD:g} x the plain version's "
                                   f"{ep:.3e}")
        got = dict(rel=max(ratios), max_abs_err=mx, bwd_ratio=max(ratios),
                   ms=cuda_ms_cold(lambda: ch.chol_solve(L, dsc, b, invs),
                                   reps),
                   plain_ms=cuda_ms_cold(lambda: ch.chol_solve_plain(L, dsc,
                                                                     b),
                                         reps),
                   library_ms=cuda_ms_cold(lambda: torch.cholesky_solve(b, L),
                                           reps),
                   ms_solve_triangular=cuda_ms_cold(lambda: pair(b), reps))
        got["ms_cholesky_solve"] = got["library_ms"]
    # bytes: the lower triangle, dsc, b and invs read once, x written once;
    # the two sweeps' own count (the triangle twice) beside it
    tri = N * (N + 1) // 2
    got["bound_ms"], got["bound_by"] = bound(
        8 * (tri + 3 * N + invs.numel()), 2 * N * N)
    got["bound_ms_two_sweeps"] = 2 * tri * 8 / PEAK_BYTES * 1e3
    say(f"[k13 {tag}] vec N={N}: kernel {got['ms']:.4f} ms plain "
        f"{got['plain_ms']:.4f} ms cholesky_solve {got['library_ms']:.4f} ms"
        f" solve_triangular pair {got['ms_solve_triangular']:.4f} ms bound "
        f"{got['bound_ms']:.4f} ms ({got['bound_by']}; two sweeps "
        f"{got['bound_ms_two_sweeps']:.4f})")
    merge(K13, "chol_subst/vec", got, tag if "chol_subst/vec" in K13
          else None)

    # a well-conditioned SPD matrix of the same N
    A = torch.randn(N, N, dtype=torch.float64, generator=g).to(dev)
    Kw = A @ A.T / N + torch.eye(N, dtype=torch.float64, device=dev)
    del A
    Lw, _, invs_w = ch.chol_factor(Kw)   # Kw consumed
    one = torch.ones(N, dtype=torch.float64, device=dev)
    bw = torch.randn(N, 1, dtype=torch.float64, generator=g).to(dev)
    with library_calls():
        ew = rel_err(ch.chol_solve(Lw, one, bw, invs_w),
                     ch.chol_solve_plain(Lw, one, bw))[0]
    say(f"[k13 {tag}] well-conditioned N={N}: kernel vs plain rel {ew:.3e} "
        f"(gate {K13_WELL:g})")
    if not ew <= K13_WELL:
        raise RuntimeError(f"K13 {tag}: well-conditioned rel {ew:.3e}")
    del Lw, Kw, invs_w

    # the Woodbury basis W = K^-1 U^T of an MI factor
    M = getattr(fac, "_M", None)
    if M and fac.kind == "cholesky":
        U = torch.zeros(N, M, dtype=torch.float64, device=dev)
        U[fac._urows, torch.arange(M, device=dev)] = 1.0
        with library_calls():
            W = bits(lambda: ch.chol_solve(L, dsc, U, invs))
            Wp = ch.chol_solve_plain(L, dsc, U)
            ek, ep = bwd_err(K, W / dsc[:, None], dsc[:, None] * U, nK), \
                bwd_err(K, Wp / dsc[:, None], dsc[:, None] * U, nK)
            rel, mx = rel_err(W, Wp)
            del W, Wp
            got = dict(rel=ek / ep, max_abs_err=mx, bwd_ratio=ek / ep,
                       ms=cuda_ms_cold(lambda: ch.chol_solve(L, dsc, U, invs),
                                       3),
                       plain_ms=cuda_ms_cold(
                           lambda: ch.chol_solve_plain(L, dsc, U), 3),
                       library_ms=cuda_ms_cold(
                           lambda: torch.cholesky_solve(U, L), 3),
                       ms_solve_triangular=cuda_ms_cold(lambda: pair(U), 3))
            got["ms_cholesky_solve"] = got["library_ms"]
        got["bound_ms"], got["bound_by"] = bound(
            8 * (tri + 2 * N * M + N + invs.numel()), 2 * N * N * M,
            PEAK_F64_TC)
        say(f"[k13 {tag}] multi N={N} M={M}: backward error {ek:.3e} "
            f"(plain {ep:.3e}, ratio {ek / ep:.2f}); W rel {rel:.3e}; kernel "
            f"{got['ms']:.3f} ms plain {got['plain_ms']:.3f} ms "
            f"cholesky_solve {got['library_ms']:.3f} ms solve_triangular "
            f"pair {got['ms_solve_triangular']:.3f} ms bound "
            f"{got['bound_ms']:.3f} ms ({got['bound_by']})")
        if not ek <= K13_BWD * ep:
            raise RuntimeError(f"K13 {tag}: multi backward error {ek:.3e} > "
                               f"{K13_BWD:g} x {ep:.3e}")
        merge(K13, "chol_subst/multi", got, tag if "chol_subst/multi" in K13
              else None)
        del U
    torch.cuda.empty_cache()
    K13_SECONDS[0] += time.perf_counter() - t0
    say(f"[k13 {tag}] {time.perf_counter() - t0:.1f} s (phase so far "
        f"{K13_SECONDS[0]:.1f} s)")


def cold_gradient(obj, name, x0, sys_, dev):
    """J and dJ/dx of a demo objective at x0 from d = 0 (one host-timed
    evaluation ending in a synchronize)."""
    J, g, _, dt = evaluate(obj, name, x0, sys_.zero_displacement(), dev)
    return J, g, dt


def evaluate(obj, name, x, d0, dev):
    """J, dJ/dx (CPU) and d of a demo objective at design x from d0,
    host-timed to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xt = torch.tensor(x, dtype=torch.float64, device=dev, requires_grad=True)
    J, d = obj({name: xt}, d0)
    J.backward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    J, g, d = float(J.detach()), xt.grad.detach().cpu(), d.detach()
    if not (np.isfinite(J) and bool(torch.isfinite(g).all())
            and bool(torch.isfinite(d).all()) and g.shape == xt.shape):
        raise RuntimeError("non-finite or misshapen evaluation")
    return J, g, d, dt


def check_cold(tag, J, g, dt, ref, tol_J=1e-8, tol_g=1e-6, key="dJ_dp"):
    """Raise unless J and the gradient agree with the reference `ref`
    (keys "J" and `key`) to tol_J and tol_g (relative)."""
    eJ = abs(J - ref["J"]) / abs(ref["J"])
    eg = rel_err(g, torch.tensor(ref[key], dtype=torch.float64))[0]
    say(f"[{tag}] cold evaluation {dt:.3f} s  J={J!r} (ref {ref['J']!r}, "
        f"rel {eJ:.2e}, gate {tol_J:g})  |dJ/dx| rel {eg:.2e} (gate "
        f"{tol_g:g})")
    if not (eJ <= tol_J and eg <= tol_g):
        raise RuntimeError(f"{tag} cold evaluation disagrees with the JAX "
                           f"CPU reference: J rel {eJ:.2e}, grad rel "
                           f"{eg:.2e}")


def report_slsqp(tag, prob, res, fac, J_start, A_pin, p0, x):
    """Print the SLSQP run; raise unless it lowered J and held the pin."""
    wf, wj = prob.eval_wall["fun"], prob.eval_wall["jac"]
    pin = float(np.abs(A_pin @ x - A_pin @ p0).max())
    say(f"[{tag}] slsqp nit {res.nit} nfev {res.nfev} njev {res.njev} "
        f"J per iteration {res.history} final {res.fun!r} (start "
        f"{J_start!r}); {res.message}")
    say(f"[{tag}] wall per fun median {float(np.median(wf)):.3f} s "
        f"(n {len(wf)}, max {max(wf):.3f}); per jac median "
        f"{float(np.median(wj)):.3f} s (n {len(wj)}, max {max(wj):.3f})")
    say(f"[{tag}] n_factor {fac.n_factor} (failed {fac.n_factor_failed}, "
        f"chol_factor info {fac.failed_info}); refactor_log "
        f"{fac.refactor_log}")
    say(f"[{tag}] pin residual {pin:.3e}")
    if not (np.isfinite(res.fun) and res.fun < J_start and res.nit >= 1
            and pin <= 1e-10):
        raise RuntimeError(f"{tag}: SLSQP did not lower J ({res.fun!r} vs "
                           f"{J_start!r}) or broke the pin ({pin:.3e})")


def timed_driver(prob):
    """Wrap what the driver calls for a fun evaluation (prob.run_model)
    and a jac evaluation (prob._linearize_all, then prob.compute_totals) to
    log their host walls: (fun walls, jac walls)."""
    fun, jac, lin = [], [], [0.0]
    run_model, linearize = prob.run_model, prob._linearize_all
    compute_totals = prob.compute_totals

    def timed_run_model():
        t0 = time.perf_counter()
        run_model()
        fun.append(time.perf_counter() - t0)

    def timed_linearize():
        t0 = time.perf_counter()
        out = linearize()
        lin[0] += time.perf_counter() - t0
        return out

    def timed_compute_totals(*args, **kwargs):
        t0 = time.perf_counter()
        out = compute_totals(*args, **kwargs)
        jac.append(time.perf_counter() - t0 + lin[0])
        lin[0] = 0.0
        return out

    prob.run_model = timed_run_model
    prob._linearize_all = timed_linearize
    prob.compute_totals = timed_compute_totals
    return fun, jac


def phase_om_mi(dev, ref):
    """The MI T-beam through the port demo's OpenMDAO graph: the cold
    run_model and totals against the JAX reference (the counted path),
    then SLSQP through run_driver."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import om_tbeam_shopt_mi as demo

    W, X = "int_energy_comp.w_int", "inputs_comp.CPS_design"
    XI, EDGE = "cpiga2xi_comp.int_para_coords", "int_xi_edge_comp.int_xi_edge"
    PIN = "cpsurf_pin_comp.cps_pin"
    t_phase = time.perf_counter()
    prob, s, d2a = demo.build_problem(
        num_el=ref["num_el"], p=ref["p"], n_pts=ref["n_pts"],
        maxiter=ref["driver"]["maxiter"], device=dev)
    op = prob.model._subs["disp_states_comp"].op
    fac = op.factor
    say(f"[setup] OM MI T-beam built in {time.perf_counter() - t_phase:.1f}"
        f" s: N={s.cp.numel()} design {prob[X].size} seam (I, N)="
        f"({s.mi.n_int}, {s.mi.n_max})")
    if not np.array_equal(prob[X], np.asarray(ref["x_design"])):
        raise RuntimeError("om-mi: the design start differs from the JAX "
                           "demo's")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.run_model()
    t_cold = time.perf_counter() - t0
    w0 = float(prob[W][0])
    e_xi = float(np.linalg.norm(prob[XI] - np.asarray(ref["xi"])))
    say(f"[om-mi] cold run_model {t_cold:.3f} s: w_int {w0!r} (ref "
        f"{ref['w_int']!r}); |xi - xi_ref| {e_xi:.3e} (gate 1e-10); |d| "
        f"{float(np.linalg.norm(prob['disp_states_comp.displacements']))!r}"
        f" (ref {ref['d_norm']!r}); newton its {op.solver.last_its}, "
        f"xi-newton its {s.c2x.last_its}")
    check_rel("om-mi", "w_int", w0, ref["w_int"], 1e-8)
    if not e_xi <= 1e-10:
        raise RuntimeError(f"om-mi: xi disagrees with the JAX CPU reference: "
                           f"{e_xi:.3e} in norm")
    t0 = time.perf_counter()
    tot = prob.compute_totals([W], [X])
    t_tot = time.perf_counter() - t0
    check_rel("om-mi", f"dw_int/dCPS_design ({t_tot:.3f} s)",
              tot[(W, X)].ravel(), ref["dw_int_dx"], 1e-6)
    counts = dict(_cuda.launch_counts)
    say_shapes("om-mi")
    say(f"[om-mi] xi route {s.c2x.route} (seams of {s.mi.n_max} points); "
        f"K7 launches "
        f"{ {k: counts[k] for k in counts if k.startswith('c2x_res_jac/')} }")
    check_counts("om-mi", counts, OM_MI_KERNELS + CHOL)

    want = ref["driver"]
    res, w1 = om_driver("om-mi", prob, fac, W, w0)
    edge = float(np.max(np.abs(prob[EDGE])))
    pin = float(np.max(np.abs(prob[PIN]
                              - prob.model._constraints[PIN]["equals"])))
    say(f"[om-mi] JAX: nit {want['nit']} nfev {want['nfev']} njev "
        f"{want['njev']}; {want['message']}; w_int -> {want['w_int_end']!r}")
    say(f"[om-mi] xi-edge residual {edge!r}; pin residual {pin!r} (ref "
        f"{want['pin_residual_max']!r})")
    check_rel("om-mi", "end w_int", w1, want["w_int_end"], 1e-8)
    if not (w1 < w0 and edge <= 1e-6
            and abs(pin - want["pin_residual_max"]) <= 1e-12
            and res.nit == want["nit"]):
        raise RuntimeError(f"om-mi: SLSQP does not end where the JAX demo's "
                           f"does: w_int {w0!r} -> {w1!r}, xi-edge {edge!r}, "
                           f"pin {pin!r}, nit {res.nit}")
    counts = dict(_cuda.launch_counts)
    say(f"[om-mi] phase {time.perf_counter() - t_phase:.1f} s; launch counts "
        f"with the driver {counts}")
    return counts, prob


# the forward design tangents' modes (phase 6e and the counted design runs)
DESIGN_KERNELS = ("shell_qp/design_fwd", "penalty_qp/design_fwd")
DESIGN_MI_KERNELS = DESIGN_KERNELS + ("mi_penalty_xi/xi_fwd",
                                      "c2x_res_jac/cp_fwd")
# launch counts of the counted design-tangent runs, by path: the OM MI
# graph's and the plate's check_partials, the tube's forward product
DESIGN_COUNTS = {}
# explicit components with more input entries than this are left out of
# check_partials on the card: their finite differences take a model
# evaluation a column (12144 at the OM MI graph's w_int, 9520 at the plate's
# KS stress) and they have no forward design mode
FD_COLUMNS_MAX = 512


def costly_fd(prob):
    """The explicit components of `prob` past FD_COLUMNS_MAX columns."""
    from goldfish_tpu_torch.om_shim import ExplicitComponent

    return [n for n, c in prob.model._subs.items()
            if isinstance(c, ExplicitComponent)
            and sum(np.size(v) for v in c._inputs.values()) > FD_COLUMNS_MAX]


def gate_partials(tag, report, bar, zero_abs=None, min_checked=0):
    """The JAX tests' check_partials criteria: every block whose FD
    Jacobian is not zero within rel `bar` (|J_fd| < 1e-10 skipped, or with
    `zero_abs` < 1e-14 held to abs error < zero_abs), at least
    `min_checked` blocks checked. Prints every block."""
    checked = 0
    for comp, pairs in report.items():
        for (of, wrt), e in pairs.items():
            nfd = float(np.linalg.norm(e["J_fd"]))
            say(f"[{tag}] {comp} d{of}/d{wrt}: rel {e['rel error']:.3e} abs "
                f"{e['abs error']:.3e} |J_fd| {nfd:.3e}")
            if nfd < (1e-14 if zero_abs is not None else 1e-10):
                if zero_abs is not None and not e["abs error"] < zero_abs:
                    raise RuntimeError(f"{tag}: {comp} d{of}/d{wrt} zero "
                                       f"block off by {e['abs error']:.3e}")
                continue
            checked += 1
            if not e["rel error"] < bar:
                raise RuntimeError(f"{tag}: {comp} d{of}/d{wrt} rel error "
                                   f"{e['rel error']:.3e} >= {bar:g}")
    say(f"[{tag}] {checked} blocks checked (rel < {bar:g})")
    if checked < min_checked:
        raise RuntimeError(f"{tag}: {checked} blocks checked, fewer than "
                           f"{min_checked}")


def phase_design_tangents(dev, ref_om_mi, prob):
    """6e: the three implicit operations' forward design products at the
    small OM MI T-beam against the JAX operations' (1e-10), then the
    counted path: check_partials of the num_el=40 OM MI graph `prob` (the
    JAX test's bars: rel < 1e-4, at least 10 blocks), which runs K1 mode 4,
    K2 mode 3, K6 mode 1 and K7 mode 4. The modes against their plain
    versions run in phases 3, 5, 7 and 10 (`fixed_cases`,
    `mi_kernel_cases`, the tube's route); the plate graph's check_partials
    in phase 11."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.operations import (
        CPIGA2XiImOperation,
        DispMintImOperation,
    )

    t_phase = time.perf_counter()
    ops = ref_om_mi["small"]["ops"]
    inp = {k: np.asarray(v) for k, v in ops["inputs"].items()}
    want_x = ops["cpiga2xi"]
    want_d = ops["disp_mint"]
    s = tbeam.build_mi(num_el=ref_om_mi["small"]["num_el"],
                       p=ref_om_mi["small"]["p"],
                       n_pts=ref_om_mi["small"]["n_pts"], device=dev)
    xop = CPIGA2XiImOperation(s)
    xop.linearize(inp["cp"], inp["xi"])
    dop = DispMintImOperation(s, rtol=1e-11)
    xi = np.asarray(want_x["solve_nonlinear"])
    dop.solve_nonlinear(inp["cp"], inp["h"], xi)
    dop.linearize(inp["cp"], inp["h"], xi,
                  np.asarray(want_d["solve_nonlinear"]))
    for op, combos, want in (
            (xop, (("d_xi",), ("d_cp",), ("d_cp", "d_xi")), want_x),
            (dop, (("d_d",), ("d_cp",), ("d_h",), ("d_xi",),
                   ("d_cp", "d_h", "d_xi", "d_d")), want_d)):
        for combo in combos:
            got = op.apply_linear_fwd(**{k: inp["t" + k[1:]] for k in combo})
            key = "fwd_" + "+".join(combo)
            check_rel("design-ops", f"{type(op).__name__} {key}", got,
                      want[key], 1e-10)
    del xop, dop, s

    excl = costly_fd(prob)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = prob.check_partials(step=1e-7, excludes=excl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say(f"[design-om-mi] check_partials {dt:.3f} s (left out: {excl})")
    gate_partials("design-om-mi", report, 1e-4, min_checked=10)
    check_counts("design-om-mi", counts, DESIGN_MI_KERNELS)
    say(f"[design] phase 6e {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: counts[k] for k in DESIGN_MI_KERNELS} }")
    return counts


def om_driver(tag, prob, fac, J, w0):
    """run_driver with its fun and jac walls: prints the outcome, the
    walls, the factorizations; returns (SciPy's result, the end J)."""
    fun, jac = timed_driver(prob)
    t0 = time.perf_counter()
    prob.run_driver()
    wall = time.perf_counter() - t0
    res = prob._driver_result
    w1 = float(np.asarray(prob[J]).ravel()[0])
    say(f"[{tag}] slsqp {wall:.2f} s: nit {res.nit} nfev {res.nfev} njev "
        f"{res.njev}; {res.message}; J {w0!r} -> {w1!r} "
        f"({100 * (1 - w1 / w0):.1f}% lower)")
    say(f"[{tag}] wall per fun median {float(np.median(fun)):.3f} s (n "
        f"{len(fun)}, max {max(fun):.3f}); per jac median "
        f"{float(np.median(jac)):.3f} s (n {len(jac)}, max {max(jac):.3f})")
    say(f"[{tag}] n_factor {fac.n_factor} (failed {fac.n_factor_failed}); "
        f"refactor_log {fac.refactor_log}; cert_log tail "
        f"{fac.cert_log[-8:]}")
    return res, w1


def om_cold(tag, prob, op, s, ref, J, X, XI, dJ, t_phase):
    """The cold run_model and compute_totals of an OpenMDAO MI graph
    against the JAX reference (J 1e-8, xi 1e-10 in norm, totals 1e-6 a
    design input); X: the design inputs, dJ their reference totals."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.run_model()
    t_cold = time.perf_counter() - t0
    w0 = float(np.asarray(prob[J]).ravel()[0])
    e_xi = float(np.linalg.norm(np.asarray(prob[XI]).ravel()
                                - np.asarray(ref["xi"])))
    say(f"[{tag}] cold run_model {t_cold:.3f} s: J {w0!r} (ref "
        f"{ref['J']!r}); |xi - xi_ref| {e_xi:.3e} (gate 1e-10); newton its "
        f"{op.solver.last_its}, xi-newton its {s.c2x.last_its}")
    check_rel(tag, "J", w0, ref["J"], 1e-8)
    if not e_xi <= 1e-10:
        raise RuntimeError(f"{tag}: xi disagrees with the JAX CPU "
                           f"reference: {e_xi:.3e} in norm")
    t0 = time.perf_counter()
    tot = prob.compute_totals([J], list(X))
    t_tot = time.perf_counter() - t0
    for x, want in zip(X, dJ):
        check_rel(tag, f"dJ/d{x.split('.')[-1]} ({t_tot:.3f} s)",
                  tot[(J, x)].ravel(), want, 1e-6)
    say(f"[{tag}] phase so far {time.perf_counter() - t_phase:.1f} s")
    return w0


def phase_evtol_mi(dev, checks, ref):
    """The eVTOL wing with moving spar and rib seams through the port
    demo's OpenMDAO graph at the demo's own size: K1-K7 at its shapes
    against their plain versions, then the counted path: the cold
    run_model and totals against the JAX reference and SLSQP through
    run_driver against the JAX run's outcome."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import evtol_wing_shopt_mi as demo

    W, X = "int_energy_comp.w_int", "inputs_comp.spar_rib_design"
    XI, EDGE = "cpiga2xi_comp.int_para_coords", "int_xi_edge_comp.int_xi_edge"
    t_phase = time.perf_counter()
    prob, s = demo.build_problem(num_el=ref["num_el"], p=ref["p"],
                                 maxiter=ref["maxiter"],
                                 variant=ref["variant"], device=dev)
    op = prob.model._subs["disp_states_comp"].op
    fac = op.factor
    say(f"[setup] eVTOL MI wing built in {time.perf_counter() - t_phase:.1f}"
        f" s: N={s.cp.numel()} design {prob[X].size} seams (I, N)="
        f"({s.mi.n_int}, {s.mi.n_max}) degree ({s.pdeg}, {s.qdeg})")
    if not np.max(np.abs(prob[X] - np.asarray(ref["x"]))) <= 1e-15:
        raise RuntimeError("evtol-mi: the design start differs from the "
                           "JAX demo's")
    phase_mi_kernels(s, checks, system="evtol")
    torch.cuda.empty_cache()

    reset_counts()
    w0 = om_cold("evtol-mi", prob, op, s, dict(ref, J=ref["w_int"]), W,
                 (X,), XI, (ref["dw_int_dx"],), t_phase)
    counts = dict(_cuda.launch_counts)
    say_shapes("evtol-mi")
    say(f"[evtol-mi] xi route {s.c2x.route} (seams of {s.mi.n_max} "
        f"points); K7 launches "
        f"{ {k: counts[k] for k in counts if k.startswith('c2x_res_jac/')} }")
    check_counts("evtol-mi", counts, OM_MI_KERNELS)

    want = ref["driver"]
    res, w1 = om_driver("evtol-mi", prob, fac, W, w0)
    x1 = np.asarray(prob[X]).ravel()
    ex = float(np.max(np.abs(x1 - np.asarray(want["x_end"][0]))))
    edge = float(np.max(np.abs(prob[EDGE])))
    say(f"[evtol-mi] JAX: nit {want['nit']} nfev {want['nfev']} njev "
        f"{want['njev']}; {want['message']}; J -> {want['J_end']!r}")
    say(f"[evtol-mi] design {x1.tolist()} (JAX {want['x_end'][0]}); max "
        f"|x - x_JAX| {ex:.3e} (gate 1e-4); xi-edge {edge:.3e}")
    if not (w1 < 0.75 * w0 and ex <= 1e-4 and edge <= 1e-8
            and abs(x1[0] - 0.30) > 0.05):
        raise RuntimeError(f"evtol-mi: SLSQP does not end where the JAX "
                           f"demo's does: J {w0!r} -> {w1!r}, design "
                           f"{x1.tolist()} ({ex:.3e} from JAX's), xi-edge "
                           f"{edge:.3e}")
    counts = dict(_cuda.launch_counts)
    say(f"[evtol-mi] phase {time.perf_counter() - t_phase:.1f} s; launch "
        f"counts with the driver {counts}")
    return counts


def phase_tube_om_mi(dev, ref):
    """The 4-patch moving-seam tube with multi-block FFD through the port
    demo's OpenMDAO graph, at the tube phases' size and pressure (their
    kernels are checked at these shapes in phase 7): the cold run_model
    and totals against the JAX reference, then SLSQP through run_driver
    against the JAX run's outcome."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import tube_shopt_mi_4patch_wffd as demo

    J = "internal_energy_comp.int_E"
    X = ("inputs_comp.CP_design_FFD0", "inputs_comp.CP_design_FFD1")
    XI = "cpiga2xi_comp.int_para"
    t_phase = time.perf_counter()
    prob, s, _ = demo.build_problem(num_el=ref["num_el"], p=ref["p"],
                                    maxiter=ref["maxiter"],
                                    pressure=ref["pressure"], device=dev)
    op = prob.model._subs["disp_states_comp"].op
    fac = op.factor
    say(f"[setup] OM 4-patch tube built in "
        f"{time.perf_counter() - t_phase:.1f} s: N={s.cp.numel()} design "
        f"{sum(prob[x].size for x in X)} seams (I, N)=({s.mi.n_int}, "
        f"{s.mi.n_max}) pressure {ref['pressure']:g}")
    for x, want in zip(X, ref["x0"]):
        if not np.max(np.abs(prob[x] - np.asarray(want))) <= 1e-15:
            raise RuntimeError("tube-om-mi: the design start differs from "
                               "the JAX demo's")
    reset_counts()
    w0 = om_cold("tube-om-mi", prob, op, s, dict(ref, J=ref["J0"]), J, X, XI,
                 ref["dJ_dx"], t_phase)
    counts = dict(_cuda.launch_counts)
    say_shapes("tube-om-mi")
    check_counts("tube-om-mi", counts, TUBE_OM_MI_KERNELS)

    want = ref["driver"]
    res, w1 = om_driver("tube-om-mi", prob, fac, J, w0)
    ex = max(float(np.max(np.abs(np.asarray(prob[x]).ravel()
                                 - np.asarray(w)))) for x, w
             in zip(X, want["x_end"]))
    xi = np.asarray(prob[XI]).ravel()[prob.model.xi_free]
    say(f"[tube-om-mi] JAX: nit {want['nit']} nfev {want['nfev']} njev "
        f"{want['njev']}; {want['message']}; J -> {want['J_end']!r}")
    say(f"[tube-om-mi] max |x - x_JAX| {ex:.3e} (gate 1e-4); free xi in "
        f"[{float(xi.min())!r}, {float(xi.max())!r}]")
    check_rel("tube-om-mi", "end J", w1, want["J_end"], 1e-6)
    if not (w1 < w0 and ex <= 1e-4 and 0.0 < xi.min() and xi.max() < 1.0):
        raise RuntimeError(f"tube-om-mi: SLSQP does not end where the JAX "
                           f"demo's does: J {w0!r} -> {w1!r}, design "
                           f"{ex:.3e} from JAX's, free xi in "
                           f"[{float(xi.min())!r}, {float(xi.max())!r}]")
    counts = dict(_cuda.launch_counts)
    say(f"[tube-om-mi] phase {time.perf_counter() - t_phase:.1f} s; launch "
        f"counts with the driver {counts}")
    return counts


# K4 group shape (nq, nj, nloc) -> launches since the last reset_counts()
K4_SHAPES: dict = {}


def record_k4_shapes():
    """Wrap system.jet_matvec, through which every K4 launch of the
    package goes, so that the smoke sees the group shapes K4 runs at
    (say_shapes prints them); the kernel's launch count is untouched."""
    from goldfish_tpu_torch.solver import system

    inner = system.jet_matvec

    def jet_matvec(y, H, R, gi, free, v):
        out = inner(y, H, R, gi, free, v)
        if H.is_cuda:
            sh = tuple(R.shape[1:])
            K4_SHAPES[sh] = K4_SHAPES.get(sh, 0) + 1
        return out

    system.jet_matvec = jet_matvec


def reset_counts():
    """Zero the kernels' launch counts and the recorded K4 shapes."""
    from goldfish_tpu_torch import _cuda

    _cuda.reset_launch_counts()
    K4_SHAPES.clear()


def say_shapes(tag):
    """Print the group shapes (nq, nj, nloc) K4 ran at since the last
    reset_counts(), each with the instantiation that served it (the index
    of its compile-time shape, -1 the runtime-shape one) and its
    launches."""
    from goldfish_tpu_torch import _cuda

    variant = _cuda.library().gf_jet_matvec_variant
    say(f"[{tag}] K4 shapes: " + ("; ".join(
        f"{sh} variant {variant(*sh)} x{n}"
        for sh, n in sorted(K4_SHAPES.items())) or "none"))


def say_route(tag, c2x, counts):
    """Print the xi solve's route (by the seams' size) and K7's launches
    by mode; a path of the fused route must not take the composed one."""
    k7 = {k: counts[k] for k in counts if k.startswith("c2x_res_jac/")}
    say(f"[{tag}] xi route {c2x.route} (seams of {c2x.mi.n_max} points); "
        f"K7 launches {k7}")
    if c2x.route == "fused" and not (k7["c2x_res_jac/step"]
                                     and k7["c2x_res_jac/solve_adjoint"]):
        raise RuntimeError(f"{tag}: the fused route's K7 modes were not "
                           f"launched: {k7}")


def check_counts(tag, counts, needed):
    say(f"[{tag}] launch counts {counts}")
    missing = [k for k in tuple(needed) + chol_needed(counts)
               if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {tag} path: "
                           f"{missing}")


def phase_tube_fixed(dev, checks, ref):
    """K8 and K1-K4 at the fixed-seam tube's shapes, then its optimization:
    cold J and dJ/dp at p0, then run_slsqp(maxiter=3)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import tube_shape_opt as demo

    t0 = time.perf_counter()
    ns = demo.setup(num_el=ref["num_el"], p=ref["p"], device=dev,
                    pressure=ref["pressure"])
    s = ns.sys
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] fixed-seam tube built in {time.perf_counter() - t0:.1f} s:"
        f" P={P} C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} ifs "
        f"{tuple(s.ifs.RA00.shape)} design {ns.p0.size}")
    cp, h, d, lam, v = tube_state(s)
    pcases = pressure_cases(s.data, d, cp, lam)
    for name, got in check_kernels(pcases, "tube-kernel").items():
        merge(checks, name, got)
    reproducibility("tube-kernel", pcases, ("pressure_qp/value_grad",),
                    outputs="(W, dW/dd)")
    del pcases
    # the follower pressure's forward design product: K8 mode c at lambda =
    # tcp (its cp-Jacobian is symmetric), against the plain jvp in cp of the
    # pressure residual; then the tube's whole forward product, counted
    from goldfish_tpu_torch.physics import loads
    from goldfish_tpu_torch.solver.system import residual_jvp

    st, pr = s.stack, s.data.pressure
    route = {"pressure_qp/adjoint": (
        lambda: loads.pressure_design_jvp(st, d, cp, pr, v),
        lambda: loads._pressure_design_jvp_plain(st, d, cp, pr, v),
        pressure_cases(s.data, d, cp, v)["pressure_qp/adjoint"][2],
        [st.R00, st.R10, st.R01, st.conn, st.wq, d, cp, pr, v])}
    merge(checks, "pressure_qp/adjoint",
          check_kernels(route, "tube-kernel design route")[
              "pressure_qp/adjoint"], "route")
    reset_counts()
    jv = residual_jvp(s.data, d, cp, h, v, lam[..., 0].contiguous())
    torch.cuda.synchronize()
    DESIGN_COUNTS["design_tube"] = dict(_cuda.launch_counts)
    say(f"[design-tube] residual_jvp |dR| {float(torch.linalg.norm(jv))!r}")
    check_counts("design-tube", DESIGN_COUNTS["design_tube"],
                 DESIGN_KERNELS + ("pressure_qp/adjoint",))
    del route, jv
    cases = fixed_cases(s.data, d, cp, h, lam, v, "tube-kernel")
    cases["shell_qp/geom_grad"] = geom_grad_case(s.stack, d, cp, h, s.E,
                                                 s.nu)
    for name, got in check_kernels(cases, "tube-kernel").items():
        merge(checks, name, got, "tube")
    del cp, h, d, lam, v, cases
    torch.cuda.empty_cache()

    fac = ns.solve.device_factor
    reset_counts()
    J0, g0, dt = cold_gradient(ns.obj, "p_xy", ns.p0, s, dev)
    check_cold("tube", J0, g0, dt, ref["fixed"])
    res = ns.prob.run_slsqp(maxiter=3, tol=1e-14)
    counts = dict(_cuda.launch_counts)
    say_shapes("tube")
    x = res.x["p_xy"]
    report_slsqp("tube", ns.prob, res, fac, J0, ns.P, ns.p0, x)
    slack = float((ns.D @ x).min() - 1e-3)
    say(f"[tube] min regu slack {slack:.3e}; newton its of the last solve "
        f"{ns.solve.solver.last_its}")
    if slack < -1e-8:
        raise RuntimeError(f"tube: regu constraint broken ({slack:.3e})")
    check_counts("tube", counts, TUBE_KERNELS + CHOL)
    return counts, fac


def phase_tube_mi(dev, checks, ref):
    """K5-K7 and K1-K4 at the moving-seam tube's shapes, then its
    optimization: cold J and dJ/dp at p_start, then run_slsqp(maxiter=3)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as demo

    t0 = time.perf_counter()
    ns = demo.setup(num_el=ref["num_el"], p=ref["p"], device=dev,
                    pressure=ref["pressure"])
    s = ns.sys
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] moving-seam tube built in {time.perf_counter() - t0:.1f} "
        f"s: P={P} C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} "
        f"seams (I, N)=({s.mi.n_int}, {s.mi.n_max}) degree "
        f"({s.pdeg}, {s.qdeg}) design {ns.p0.size}")
    # K8 on the moving-seam tube's own stack, at d = seeded noise (1e-3 of
    # the CP scale on free dofs)
    rng = np.random.default_rng(7)
    cp = s.cp
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * s.data.free
    lam = T(rng.normal(size=tuple(cp.shape))) * s.data.free
    for name, got in check_kernels(pressure_cases(s.data, d, cp, lam),
                                   "tube-mi-kernel").items():
        merge(checks, name, got, "tube_mi")
    del d, lam
    phase_mi_kernels(s, checks, system="tube")
    torch.cuda.empty_cache()

    fac = ns.forward.solve_d.device_factor
    reset_counts()
    J0, g0, dt = cold_gradient(ns.obj, "p_ffd", ns.p_start, s, dev)
    check_cold("tube-mi", J0, g0, dt, ref["mi"])
    say(f"[tube-mi] xi-newton its {s.c2x.last_its}; seam subspace M "
        f"{fac._M}")
    res = ns.prob.run_slsqp(maxiter=3, tol=1e-12)
    counts = dict(_cuda.launch_counts)
    say_shapes("tube-mi")
    report_slsqp("tube-mi", ns.prob, res, fac, J0, ns.A_pin2, ns.p0,
                 res.x["p_ffd"])
    say(f"[tube-mi] xi-newton its of the last solve {s.c2x.last_its}; "
        f"seam subspace M {fac._M}; newton its "
        f"{ns.forward.solve_d.solver.last_its}")
    check_counts("tube-mi", counts, TUBE_MI_KERNELS + CHOL)
    say_route("tube-mi", s.c2x, counts)
    return counts, fac, s.c2x


# ------------------------------------------------------------ plate
def stress_cases(st, E, nu, d, cp, h, gbar, through):
    """K9 in both modes at one fiber: name -> (kernel fn, plain fn, flops,
    inputs)."""
    from goldfish_tpu_torch.physics import kl_shell

    z = kl_shell.ZETA[through]
    P, Ne, Q, L = st.R00.shape
    nqp = P * Ne * Q
    jets = 2 * 15 * L * 2 + 2 * L          # X, z jets + h per qp
    ins = [st.R00, st.R10, st.R01, st.R20, st.R11, st.R02, st.conn, d, cp,
           h, E, nu]
    # the VJP: the forward pass, its hand-written reverse sweep, B^T of the
    # 31 jet cotangents a qp and the nodes' sums of the (element, local)
    # partials; beside it the dual-number kernel it replaced (two passes of
    # 16 and 15 directions, ~(k + 1) x the value's operations each)
    vjp = nqp * (jets + DENS_VM + SWEEP_VM + 62 * L) + P * Ne * L * 7
    return {
        "vm_stress_qp/value": (
            lambda: kl_shell.vm_stress_value(st, d, cp, h, E, nu, z),
            lambda: kl_shell._stress_plain(st, d, cp, h, E, nu, z),
            nqp * (jets + DENS_VM), ins),
        "vm_stress_qp/vjp": (
            lambda: kl_shell.vm_stress_vjp(st, d, cp, h, E, nu, z, gbar),
            lambda: kl_shell._stress_vjp_plain(st, d, cp, h, E, nu, z, gbar),
            vjp, ins + [gbar],
            {"flops_dual": nqp * (jets + 33 * DENS_VM + 62 * L)}),
        # the rows: the forward pass, the sweep at a cotangent of 1 and B^T
        # of the 31 jet cotangents a qp, written (no sums over qps)
        "vm_stress_qp/rows": (
            lambda: kl_shell.vm_stress_rows(st, d, cp, h, E, nu, z),
            lambda: kl_shell._stress_rows_plain(st, d, cp, h, E, nu, z),
            nqp * (jets + DENS_VM + SWEEP_VM + 62 * L), ins),
    }


def rows_against_vjp(st, E, nu, d, cp, h, gbar, tag, tol=1e-13):
    """K9 mode 2's rows over 5 launches bit for bit, and summed against
    gbar over the qps and scattered through conn (in plain PyTorch) equal
    to mode 1's VJP: the difference, in norm, within tol of the norm of
    the same sums of the terms' magnitudes (the two sum in other orders,
    and the cp gradient's terms cancel: its relative error in norm is
    printed beside it)."""
    from goldfish_tpu_torch.physics import kl_shell

    outs = [kl_shell.vm_stress_rows(st, d, cp, h, E, nu, 0.5)
            for _ in range(5)]
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    P, C = cp.shape[:2]
    contrib = torch.einsum("peqlc,peq->pelc", outs[0], gbar)
    tot = kl_shell._index_add_nodes(st.conn, contrib, P, C)
    mag = kl_shell._index_add_nodes(st.conn, torch.einsum(
        "peqlc,peq->pelc", outs[0].abs(), gbar.abs()), P, C)
    vjp = kl_shell.vm_stress_vjp(st, d, cp, h, E, nu, 0.5, gbar)
    parts = [(tot[..., 0:3], mag[..., 0:3]), (tot[..., 3:6], mag[..., 3:6]),
             (tot[..., 6], mag[..., 6])]
    errs = [float(torch.linalg.norm(t_ - v) / torch.linalg.norm(m))
            for (t_, m), v in zip(parts, vjp)]
    rels = [rel_err(t_, v)[0] for (t_, _), v in zip(parts, vjp)]
    say(f"[{tag}] vm_stress_qp/rows over 5 launches bit-identical {same}; "
        f"rows . gbar against vm_stress_qp/vjp (dd, dcp, dh): against the "
        f"summands' magnitude " + " ".join(f"{e:.3e}" for e in errs)
        + f" (gate {tol:g}), relative " + " ".join(f"{e:.3e}" for e in rels))
    if not same:
        raise RuntimeError("vm_stress_qp/rows: its output changes from "
                           "launch to launch")
    if not max(errs) <= tol:
        raise RuntimeError(f"vm_stress_qp/rows summed against a cotangent "
                           f"disagrees with vm_stress_qp/vjp: {errs}")


def phase_plate_kernels(s, checks, seed=8):
    """K9 (top, then bottom) and K1-K4 at the plate's shapes, at d = the
    Newton solution plus seeded noise (1e-3 of its largest entry)."""
    from goldfish_tpu_torch.physics import kl_shell

    dev = s.cp.device
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    cp, h = s.cp, s.h_init
    t0 = time.perf_counter()
    d = s.solve_nonlinear(rtol=1e-10)
    torch.cuda.synchronize()
    real = s.stack.wq > 0
    lo = {th: float(kl_shell.qp_stress_vm(s.stack, d, cp, h, s.E, s.nu,
                                          through=th)[real].min())
          for th in ("top", "bottom")}
    say(f"[plate-kernel] Newton solve {time.perf_counter() - t0:.2f} s; "
        f"smallest sigma of a real qp at the solution: top {lo['top']!r} "
        f"bottom {lo['bottom']!r}")
    if not min(lo.values()) > 0.0:
        raise RuntimeError("a real qp of the plate has sigma = 0 (no "
                           "derivative there)")
    dn = d + T(1e-3 * float(d.abs().max())
               * rng.normal(size=tuple(cp.shape))) * s.data.free
    gbar = T(rng.normal(size=tuple(s.stack.wq.shape)))
    for th in ("top", "bottom"):
        got = check_kernels(stress_cases(s.stack, s.E, s.nu, dn, cp, h, gbar,
                                         th), f"plate-kernel {th}",
                            tol=STRESS_TOL)
        for name, g in got.items():
            merge(checks, name, g)
    # [kernel C2] vm vjp: no atomics, so the same bits on every launch
    outs = [kl_shell.vm_stress_vjp(s.stack, dn, cp, h, s.E, s.nu, 0.5, gbar)
            for _ in range(5)]
    same = all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
    say(f"[kernel C2] vm vjp vm_stress_qp/vjp: (dd, dcp, dh) over 5 launches "
        f"bit-identical {same}")
    if not same:
        raise RuntimeError("vm_stress_qp/vjp: its output changes from launch "
                           "to launch")
    rows_against_vjp(s.stack, s.E, s.nu, dn, cp, h, gbar, "plate-kernel")
    lam = T(rng.normal(size=tuple(cp.shape))) * s.data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    for name, got in check_kernels(fixed_cases(s.data, dn, cp, h, lam, v,
                                               "plate-kernel"),
                                   "plate-kernel").items():
        merge(checks, name, got, "plate")


def check_rel(tag, what, got, ref, tol):
    e = rel_err(torch.as_tensor(np.asarray(got, dtype=np.float64)),
                torch.as_tensor(np.asarray(ref, dtype=np.float64)))[0]
    say(f"[{tag}] {what} rel {e:.3e} (gate {tol:g})")
    if not e <= tol:
        raise RuntimeError(f"{tag}: {what} disagrees with its reference: "
                           f"rel {e:.3e} > {tol:g}")


def phase_plate(dev, checks, ref):
    """The plate kernels, then the stress demo through its OpenMDAO graph:
    cold run_model and totals against the reference, then run_driver."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo
    from goldfish_tpu_torch.operations.exops import MaxvMStressExOperation

    t0 = time.perf_counter()
    prob, s, th, sigma_allow, sigma0 = demo.build_problem(
        num_el=ref["num_el"], maxiter=ref["maxiter"], device=dev)
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] plate built in {time.perf_counter() - t0:.1f} s: P={P} "
        f"C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} ifs "
        f"{tuple(s.ifs.RA00.shape)} design {th.n_ffd}; sigma0 {sigma0!r} "
        f"(ref {ref['sigma0']!r}) sigma_allow {sigma_allow!r}")
    check_rel("plate", "sigma0", sigma0, ref["sigma0"], 1e-8)
    phase_plate_kernels(s, checks)
    torch.cuda.empty_cache()

    op = prob.model._subs["disp_states_comp"].op
    fac = op.factor
    comp = prob.model._subs["max_vmstress_comp"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.run_model()
    t_cold = time.perf_counter() - t0
    say(f"[plate] cold run_model {t_cold:.3f} s: KS stress "
        f"{float(prob[demo.SIG][0])!r} (ref {ref['sigma_ks']!r}) volume "
        f"{float(prob[demo.VOL][0])!r} (ref {ref['volume']!r}); newton its "
        f"{op.solver.last_its}")
    check_rel("plate", "KS stress (rho 100)", prob[demo.SIG], ref["sigma_ks"],
              1e-8)
    check_rel("plate", "volume", prob[demo.VOL], ref["volume"], 1e-8)
    t0 = time.perf_counter()
    tot = prob.compute_totals([demo.VOL], [demo.FFD])
    check_rel("plate", f"dvolume/dh_ffd ({time.perf_counter() - t0:.3f} s)",
              tot[(demo.VOL, demo.FFD)].ravel(), ref["dvolume_dh_ffd"], 1e-6)
    op100 = comp.op
    comp.op = MaxvMStressExOperation(s, rho=ref["rho_grad"], through="top")
    prob.run_model()
    check_rel("plate", "KS stress (rho 50/m)", prob[demo.SIG],
              ref["sigma_ks_rho_grad"], 1e-8)
    t0 = time.perf_counter()
    tot = prob.compute_totals([demo.SIG], [demo.FFD])
    check_rel("plate", f"dsigma_KS/dh_ffd at rho 50/m "
              f"({time.perf_counter() - t0:.3f} s)",
              tot[(demo.SIG, demo.FFD)].ravel(), ref["dsigma_dh_ffd"], 1e-6)
    comp.op = op100

    t0 = time.perf_counter()
    out = demo.run(prob)
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say_shapes("plate")
    res, log = out.result, out.log
    say(f"[plate] slsqp {wall:.2f} s: nit {res.nit} nfev {res.nfev} njev "
        f"{res.njev}; {res.message}")
    say(f"[plate] (volume, KS stress) per model evaluation "
        f"{log.evaluations}")
    say(f"[plate] volume {out.V0!r} -> {out.V1!r}; KS stress {out.s1!r} "
        f"(allowable {sigma_allow!r}); reference end volume "
        f"{ref['slsqp']['volume_end']!r} stress {ref['slsqp']['sigma_end']!r}"
        f" (nit {ref['slsqp']['nit']} nfev {ref['slsqp']['nfev']} njev "
        f"{ref['slsqp']['njev']})")
    say(f"[plate] wall per fun median {float(np.median(log.fun_wall)):.3f} s "
        f"(n {len(log.fun_wall)}, max {max(log.fun_wall):.3f}); per jac "
        f"median {float(np.median(log.jac_wall)):.3f} s (n "
        f"{len(log.jac_wall)}, max {max(log.jac_wall):.3f})")
    say(f"[plate] n_factor {fac.n_factor} (failed {fac.n_factor_failed}, "
        f"chol_factor info {fac.failed_info}); refactor_log "
        f"{fac.refactor_log}")
    held = {"lighter": out.V1 < out.V0,
            "stress_le_1.02_allow": out.s1 <= 1.02 * sigma_allow,
            "stress_ge_0.95_allow": out.s1 >= 0.95 * sigma_allow}
    need = {k for k, v in ref["slsqp"]["assertions"].items() if v}
    need.add("lighter")
    say(f"[plate] demo assertions {held}; the reference meets {need}")
    missed = [k for k in need if not held[k]]
    if missed or not np.isfinite(out.s1):
        raise RuntimeError(f"plate SLSQP misses {missed} (the reference "
                           f"meets them)")
    check_counts("plate", counts, PLATE_KERNELS + CHOL)
    # the plate graph's check_partials (phase 6e's counted design run on the
    # plate): the JAX test's bars, rel < 5e-5 at step 1e-7, zero blocks abs
    # < 1e-8 (tests/test_om_adapters.py:43-58), at SLSQP's end state
    excl = costly_fd(prob)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = prob.check_partials(step=1e-7, excludes=excl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    DESIGN_COUNTS["design_plate"] = dict(_cuda.launch_counts)
    say(f"[design-plate] check_partials {dt:.3f} s (left out: {excl})")
    gate_partials("design-plate", report, 5e-5, zero_abs=1e-8,
                  min_checked=4)
    check_counts("design-plate", DESIGN_COUNTS["design_plate"],
                 DESIGN_KERNELS)
    return counts, fac


def phase_plate_sibling(dev, ref):
    """The sibling demo (minimum W_int at constant volume) at the plate's
    size: cold run_model and compute_totals against the reference."""
    from goldfish_tpu_torch.demos import om_plate_var_th_opt_wint as demo

    prob, s, th = demo.build_problem(num_el=ref["num_el"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.run_model()
    t_cold = time.perf_counter() - t0
    w = "int_energy_comp.w_int"
    vol = "volume_comp.volume"
    ffd = "inputs_comp.thickness_FFD"
    say(f"[plate-sibling] cold run_model {t_cold:.3f} s: w_int "
        f"{float(prob[w][0])!r} (ref {ref['w_int']!r})")
    check_rel("plate-sibling", "w_int", prob[w], ref["w_int"], 1e-8)
    t0 = time.perf_counter()
    tot = prob.compute_totals([w, vol], [ffd])
    dt = time.perf_counter() - t0
    check_rel("plate-sibling", f"dw_int/dh_ffd ({dt:.3f} s)",
              tot[(w, ffd)].ravel(), ref["dw_int_dh_ffd"], 1e-6)
    check_rel("plate-sibling", "dvolume/dh_ffd", tot[(vol, ffd)].ravel(),
              ref["dvolume_dh_ffd"], 1e-6)


# ------------------------------------------------------------ CAD path
def phase_vmstress(dev):
    """The stress field's OM component at the small plate (num_el=3, p=2,
    2 patches) on the card, at the card's Newton solution: the counted
    path is run_model, compute_partials (the dense Jacobians from K9 mode
    2's rows) and the operation's VJP (mode 1), each against the same at
    the same inputs on CPU tensors (the plain versions), gated at how far
    the CPU's own results move when CP_IGA and the displacements move by
    one ulp (the worst of three seeded moves: at the exact solution some
    qps' sigma is small and the sweep's 1 / sigma amplifies the rounding),
    never below 1e-12."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import plate
    from goldfish_tpu_torch.om_comps.components import VMStressComp, om

    def component(device):
        s = plate.build(num_el=3, p=2, num_patches=2, device=device)
        comp = VMStressComp(nonmatching_sys=s)
        comp.init_parameters()
        model = om.Group()
        model.add_subsystem("vm", comp)
        prob = om.Problem(model=model)
        prob.setup()
        return s, comp, prob

    def run(comp, prob, cp, u):
        prob["vm.CP_IGA"] = cp
        prob["vm.displacements"] = u
        prob.run_model()
        partials = {}
        comp.compute_partials(
            {n: prob["vm." + n] for n in ("CP_IGA", "thickness_IGA",
                                          "displacements")}, partials)
        ct = np.random.default_rng(14).normal(size=comp.op.out_size)
        vjp = comp.op.vjp(prob["vm.CP_IGA"], prob["vm.thickness_IGA"], u, ct)
        J = [partials["von_mises_stress", n] for n in
             ("CP_IGA", "thickness_IGA", "displacements")]
        return [np.array(prob["vm.von_mises_stress"])] + J + list(vjp)

    s, comp, prob = component(dev)
    d = s.solve_nonlinear(rtol=1e-12)
    u = comp.op.layout.to_flat(d).reshape(-1).cpu().numpy()
    cp = np.array(prob["vm.CP_IGA"])
    reset_counts()
    t0 = time.perf_counter()
    got = run(comp, prob, cp, u)
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    _, comp_c, prob_c = component("cpu")
    t0 = time.perf_counter()
    want = run(comp_c, prob_c, cp, u)
    dt_c = time.perf_counter() - t0
    keys = {"field": [0], "dS/dcp": [1], "dS/dh": [2], "dS/dd": [3],
            "vjp": [4, 5, 6]}
    errs, gates = {}, {}
    for k, ix in keys.items():
        errs[k] = max(rel_err(got[i], want[i])[0] for i in ix)
        gates[k] = max(1e-12, ulp_moves(
            lambda c, uu, ix=ix: [run(comp_c, prob_c, c, uu)[i]
                                  for i in ix], [cp, u]))
    J = got[1:4]
    say(f"[vmstress] VMStressComp run_model + compute_partials + vjp "
        f"{dt:.3f} s on the card ({dt_c:.3f} s on the CPU): field "
        f"{got[0].size} qps, Jacobians {J[0].shape} {J[1].shape} "
        f"{J[2].shape}; against the CPU " + " ".join(
            f"{k} {v:.3e} (gate {gates[k]:.3e})" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= gates[k]}
    if bad:
        raise RuntimeError(f"VMStressComp on the card disagrees with the "
                           f"CPU: {bad}")
    check_counts("vmstress", counts, VMSTRESS_KERNELS)
    return counts


def check_start(tag, prob, want, tol_J=1e-8, tol_g=1e-6):
    """The scaled objective and its gradient at the start design (the
    OptProblem callables at x0) against the JAX demo's."""
    fun, jac, _ = prob._build_callables()
    x0 = prob._x0()
    t0 = time.perf_counter()
    g = jac(x0)
    J = fun(x0)
    dt = time.perf_counter() - t0
    check_cold(tag, J, g, dt, dict(J=want["J"], grad=want["grad"]),
               tol_J, tol_g, key="grad")
    return J


def end_vs_ref(tag, res, want, tol):
    """SLSQP's end against the JAX run's: J lower than its first
    iterate's, the end J within tol (relative)."""
    e = abs(res.fun - want["fun"]) / abs(want["fun"])
    say(f"[{tag}] slsqp nit {res.nit} nfev {res.nfev} njev {res.njev} "
        f"(ref {want['nit']}/{want['nfev']}/{want['njev']}): J "
        f"{res.history[0] if res.history else float('nan')!r} -> "
        f"{res.fun!r} (ref {want['fun']!r}, rel {e:.3e}, gate {tol:g})")
    if not (res.history and res.fun < res.history[0]):
        raise RuntimeError(f"{tag}: SLSQP did not lower J")
    if not e <= tol:
        raise RuntimeError(f"{tag}: end J {res.fun!r} is not the JAX run's "
                           f"{want['fun']!r} (rel {e:.3e} > {tol:g})")


# K9 at the trimmed plate in tension: its membrane strain a - A, formed
# from the positions as x . x - X . X in both the kernel and its plain
# version (the JAX package's formula), keeps eps |X|^2 / |2 X . z| of
# relative accuracy (ROADMAP C14), so the plain version's own rows move by
# ~8e-12 when cp moves by one ulp. There each mode is gated at the worst
# of three seeded one-ulp moves of its plain version
# (`stress_conditioning`), never below TRIM_BAR, the bar that K1-K4 meet
# at this stack, or the mode's STRESS_TOL where that is tighter
TRIM_BAR = 4.2e-12


def ulp_moves(fn, args, seeds=(6, 7, 8)):
    """The worst relative change (in norm, over fn's outputs) of fn(*args)
    when every array in args is moved by one ulp with seeded signs."""
    def out(a):
        a = fn(*a)
        return a if isinstance(a, (tuple, list)) else (a,)

    def move(x, rng):
        sign = rng.choice([-1.0, 1.0], size=tuple(x.shape))
        if torch.is_tensor(x):
            sign = torch.tensor(sign, dtype=x.dtype, device=x.device)
        return x * (1.0 + 2.2e-16 * sign)

    base = out(args)
    worst = 0.0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        moved = out([move(x, rng) for x in args])
        worst = max(worst, max(rel_err(m, b)[0]
                               for m, b in zip(moved, base)))
    return worst


def stress_conditioning(st, E, nu, d, cp, h, gbar):
    """K9's gates at the trimmed plate: how far each mode's plain version
    itself moves (relative in norm, the worst of three seeded moves of cp
    by one ulp), each floored at min(STRESS_TOL, TRIM_BAR)."""
    from goldfish_tpu_torch.physics import kl_shell

    plain = {"vm_stress_qp/value": (kl_shell._stress_plain, ()),
             "vm_stress_qp/vjp": (kl_shell._stress_vjp_plain, (gbar,)),
             "vm_stress_qp/rows": (kl_shell._stress_rows_plain, ())}
    moves = {name: ulp_moves(lambda c, fn=fn, extra=extra:
                             fn(st, d, c, h, E, nu, 0.5, *extra), [cp])
             for name, (fn, extra) in plain.items()}
    tol = {name: max(min(STRESS_TOL[name], TRIM_BAR), m)
           for name, m in moves.items()}
    say("[trim-kernel conditioning] K9's plain version at cp moved by one "
        "ulp (worst of 3): " + " ".join(
            f"{n.split('/')[1]} {m:.3e} (gate {tol[n]:.3e})"
            for n, m in moves.items()))
    return tol


def phase_trim_kernels(s, checks, seed=23):
    """K1-K4 and K9 (its three modes, top fiber; `stress_conditioning`'s
    gates) at the
    trimmed plate's stack (cut-cell weights, void qps with real geometry,
    runs of 16 sub-cells on one dof map for K3), at d = the Newton
    solution plus seeded noise; K9 mode 2 also against mode 1 and bit for
    bit."""
    dev = s.cp.device
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    cp, h = s.cp, s.h_init
    d = s.solve_nonlinear(rtol=1e-10)
    dn = d + T(1e-3 * float(d.abs().max())
               * rng.normal(size=tuple(cp.shape))) * s.data.free
    wq = s.stack.wq
    say(f"[trim-kernel] stack {tuple(s.stack.R00.shape)}: "
        f"{int((wq == 0).sum())} void qps (real geometry, weight 0)")
    gbar = T(rng.normal(size=tuple(wq.shape)))
    tol = stress_conditioning(s.stack, s.E, s.nu, dn, cp, h, gbar)
    got = check_kernels(stress_cases(s.stack, s.E, s.nu, dn, cp, h, gbar,
                                     "top"), "trim-kernel", tol=tol)
    for name, g in got.items():
        merge(checks, name, g, "trim")
    rows_against_vjp(s.stack, s.E, s.nu, dn, cp, h, gbar, "trim-kernel")
    lam = T(rng.normal(size=tuple(cp.shape))) * s.data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    for name, g in check_kernels(fixed_cases(s.data, dn, cp, h, lam, v,
                                             "trim-kernel"),
                                 "trim-kernel").items():
        merge(checks, name, g, "trim")


def phase_plate_hole(dev, checks, ref):
    """The trimmed plate demo at its defaults (num_el=8, trim_subdiv=4,
    maxiter 20): its kernels at the trimmed stack, then the counted path:
    the start J and gradient against the JAX demo's (1e-8, 1e-6), the
    demo's `main`: J lowered, the end J within 1e-6 of the JAX run's, and
    near > 1.05 far where the JAX run meets it (at num_el=8 it does not:
    ROADMAP C12)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import plate_hole_thickness_opt as demo

    kw = ref["kw"]
    t0 = time.perf_counter()
    ns = demo.setup(kw["num_el"], device=dev)
    s = ns.sys
    say(f"[setup] trimmed plate built in {time.perf_counter() - t0:.1f} s: "
        f"stack {tuple(s.stack.R00.shape)} N={s.stack.max_cp * 3}, free "
        f"dofs {int(s.data.free.sum())}")
    phase_trim_kernels(s, checks)
    del ns, s
    torch.cuda.empty_cache()
    check_start("plate-hole", demo.setup(kw["num_el"], device=dev).prob,
                ref["start"])
    reset_counts()
    t0 = time.perf_counter()
    res, s, th, (near, far) = demo.main(**kw, results="", verbose=False,
                                        device=dev)
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say_shapes("plate-hole")
    say(f"[plate-hole] main {wall:.2f} s; near {near!r} far {far!r} "
        f"(ref {ref['run']['near']!r} {ref['run']['far']!r}), ratio "
        f"{near / far:.3f}")
    end_vs_ref("plate-hole", res, ref["run"], 1e-6)
    # tests/test_demos.py's criterion (at num_el=4), gated where the JAX
    # run at this size meets it
    need = ref["run"]["near"] > 1.05 * ref["run"]["far"]
    say(f"[plate-hole] near > 1.05 far: {near > 1.05 * far} (the JAX run: "
        f"{need})")
    if need and not near > 1.05 * far:
        raise RuntimeError("plate-hole: the hole band did not thicken")
    check_counts("plate-hole", counts, TRIM_KERNELS)
    return counts


def phase_thickness_plate(dev, ref):
    """The variable-thickness plate demo at its defaults (num_el=4,
    maxiter 30): the start against the JAX demo's, then `main` with its
    checkpoint and VTK output: J lowered and its end against the JAX
    run's (1e-4)."""
    import tempfile

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import thickness_opt_plate as demo

    kw = ref["kw"]
    check_start("thickness-plate", demo.setup(kw["num_el"], device=dev).prob,
                ref["start"])
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        res, s, th = demo.main(**kw, results=out, verbose=False, device=dev)
        files = sorted(os.listdir(out))
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say(f"[thickness-plate] main {wall:.2f} s, wrote {files}")
    end_vs_ref("thickness-plate", res, ref["run"], 1e-4)
    check_counts("thickness-plate", counts, WING_KERNELS)
    return counts


def preprocessor_vs_cpu(tag, surfs, pre, dev, **kw):
    """The same intersections computed with the CPIGA2Xi polish on the
    CPU: the card's parametric points within 1e-10."""
    from goldfish_tpu_torch.geometry import native
    from goldfish_tpu_torch.geometry.preprocessing import Preprocessor

    t0 = time.perf_counter()
    cpu = Preprocessor(surfs, device="cpu").compute_intersections(**kw)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    Preprocessor(surfs, device=dev).compute_intersections(**kw)
    t_dev = time.perf_counter() - t0
    same = (cpu.mapping_list == pre.mapping_list
            and cpu.intersections_type == pre.intersections_type)
    err = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(
        pre.intersections_para_coords, cpu.intersections_para_coords)
        for k in (0, 1))
    say(f"[{tag}] preprocessor: {pre.num_intersections} intersections "
        f"{sorted(set(pre.intersections_type))}, {t_dev:.3f} s with the "
        f"polish on the card, {t_cpu:.3f} s on the CPU; geometry through "
        f"{'the native kernel' if native.available() else 'NumPy'}; xi "
        f"against the CPU max abs {err:.3e} (gate 1e-10)")
    if not same or not err <= 1e-10:
        raise RuntimeError(f"{tag}: the preprocessor on the card disagrees "
                           f"with the CPU")


def phase_evtol_kernels(s, checks, seed=26):
    """K1-K4, K2 and K8 (its three modes) at the eVTOL wing's stack (16
    patches, p = 3, 44 edge seams) against their plain versions (at
    KERNEL_TOL), at d = seeded noise (1e-3 of the CP scale on free dofs:
    the hinged wing's tangent is singular in f64, ROADMAP C13, so no
    solve), lam and v random."""
    dev = s.cp.device
    rng = np.random.default_rng(seed)
    cp, h = s.cp, s.h_init
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * s.data.free
    lam = T(rng.normal(size=tuple(cp.shape))) * s.data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    for name, got in check_kernels(pressure_cases(s.data, d, cp, lam),
                                   "evtol-kernel").items():
        merge(checks, name, got, "evtol_cad")
    cases = fixed_cases(s.data, d, cp, h, lam, v, "evtol-kernel")
    cases["shell_qp/geom_grad"] = geom_grad_case(s.stack, d, cp, h, s.E,
                                                 s.nu)
    for name, got in check_kernels(cases, "evtol-kernel").items():
        merge(checks, name, got, "evtol_cad")


def phase_evtol(dev, checks, ref):
    """The eVTOL wing demo at its defaults (3 sections, num_el=3, p=3,
    maxiter 5): the IGES round trip and the preprocessor (against the CPU
    port's), its kernels at the wing's stack (`phase_evtol_kernels`), the
    start J and gradient against the JAX demo's, then the counted path
    (the setup and SLSQP): J lowered, the end against the JAX run's. The
    wing is clamped along one edge of its root rib only, a hinge that only
    the follower pressure resists: at this size the equilibrated tangent's
    smallest eigenvalue is -1.5e-14 against 4.5 (singular in f64; ROADMAP
    C13), and J moves by 1.4e-5 between the port's own CPU and card runs:
    J 1e-4, the gradient 1e-2, the end J 1e-3."""
    import tempfile

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import evtol_wing_shopt as demo

    kw = dict(ref["kw"])
    maxiter = kw.pop("maxiter")
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp
        try:
            ns = demo.setup(**kw, verbose=False, device=dev)
            preprocessor_vs_cpu("evtol", ns.sys.surfs, ns.pre, dev,
                                rtol=2e-4, mortar_refine=2)
            phase_evtol_kernels(ns.sys, checks)
            check_start("evtol", ns.prob, ref["start"], 1e-4, 1e-2)
            del ns
            torch.cuda.empty_cache()
            reset_counts()
            t0 = time.perf_counter()
            ns = demo.setup(**kw, verbose=False, device=dev)
            t_setup = time.perf_counter() - t0
        finally:
            tempfile.tempdir = None
    say(f"[evtol] setup {t_setup:.2f} s (IGES round trip, preprocessor, "
        f"system): {ns.sys.num_splines} patches, N = "
        f"{ns.sys.num_splines * ns.sys.stack.max_cp * 3}, "
        f"{len(ns.sys.specs)} interfaces")
    t0 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-12)
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    fac = ns.solve.device_factor
    say(f"[evtol] slsqp {wall:.2f} s; n_factor {fac.n_factor} (failed "
        f"{fac.n_factor_failed}, kind {fac.kind})")
    end_vs_ref("evtol", res, ref["run"], 1e-3)
    check_counts("evtol", counts, TUBE_KERNELS)
    return counts


def phase_curved(dev, checks, ref):
    """The curved moving-seam T-beam at its defaults (num_el=4, p=3,
    maxiter 4): the preprocessor's traced seam polished by CPIGA2Xi on the
    card (K5, K7) against the CPU port's, K5-K7 and K1-K4 at its shapes
    (`phase_mi_kernels`), the start J and gradient against the JAX
    demo's, then the counted path (the setup, its preprocessor included,
    and SLSQP): J lowered, the end within 1e-4 of the JAX run's."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import shape_opt_mint_tbeam_curved as demo

    kw = dict(ref["kw"])
    maxiter = kw.pop("maxiter")
    reset_counts()
    t0 = time.perf_counter()
    ns = demo.setup(**kw, device=dev)
    say(f"[curved] setup {time.perf_counter() - t0:.2f} s; preprocessor "
        f"launches {{traced_rows: {_cuda.launch_counts['traced_rows']}, "
        f"c2x step: {_cuda.launch_counts['c2x_res_jac/step']}}}")
    preprocessor_vs_cpu("curved", ns.sys.surfs, ns.pre, dev, rtol=2e-4,
                        mortar_refine=2)
    phase_mi_kernels(ns.sys, checks, system="curved")
    torch.cuda.empty_cache()
    check_start("curved", demo.setup(**kw, device=dev).prob, ref["start"])
    reset_counts()
    t0 = time.perf_counter()
    ns = demo.setup(**kw, device=dev)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-14)
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say(f"[curved] setup {t_setup:.2f} s, slsqp {wall:.2f} s")
    say_route("curved", ns.sys.c2x, counts)
    end_vs_ref("curved", res, ref["run"], 1e-4)
    check_counts("curved", counts, MI_PATH_KERNELS)
    return counts


def phase_caddee(dev, ref):
    """The CADDEE wing at its defaults (3 sections, num_el=3, p=3, 4
    fixed-point passes): `main` (the intersection cache written and read
    back, KLShellModel, the coupled solves and their adjoint): W_int and
    the tip displacement (1e-8) and dW_int/dh (1e-6) against the JAX
    demo's."""
    import tempfile

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import caddee_aeroelastic_wing as demo

    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp
        try:
            J0, tip, gh, model = demo.main(**ref["kw"], verbose=False,
                                           device=dev)
        finally:
            tempfile.tempdir = None
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    its = model.field_solver().solver.its_log
    say(f"[caddee] main {wall:.2f} s: {model.num_surfs} surfaces, "
        f"{model.preprocessor.num_intersections} intersections; Newton "
        f"iterations per pass {its}; W_int {J0!r} (ref {ref['J0']!r}), tip "
        f"u_z {float(tip[2])!r} (ref {ref['tip'][2]!r})")
    check_rel("caddee", "W_int", J0, ref["J0"], 1e-8)
    check_rel("caddee", "tip displacement", tip, ref["tip"], 1e-8)
    check_rel("caddee", "dW_int/dh (coupled adjoint)", gh.cpu().numpy(),
              ref["gh"], 1e-6)
    check_counts("caddee", counts, WING_KERNELS)
    return counts


# ------------------------------------------------------------ pegasus-91
def k10_ops(be, L, Li):
    """f64 operations of one K10 launch's entries, each counted once: a qp
    of an entry costs 18 nj nl (nj + nl) through T (its T_q, then
    sum_j R_r T_q); the cross quadrants count one direction (the other is
    its transpose)."""
    from goldfish_tpu_torch.solver import krylov

    kind = be.kind.cpu().numpy()
    nq = be.nq.cpu().numpy()
    ops = 0
    for k in be.kinds:
        if k == krylov.CROSS_BA:
            continue
        nj, nl = krylov._jets(k, L, Li)
        ops += 18 * nj * nl * (nj + nl) * int(nq[kind == k].sum())
    return ops


def pair_cases(data, d, cp, h):
    """K10 as the preconditioners run it: stage 1 alone into the patch
    blocks (`patch_block_precond`), stages 1 + 2 into the pair blocks
    (`PairSchwarz.assemble`): name -> (kernel fn, plain fn, flops, inputs,
    f64 rate, {"flops_full": the parent's count}). Flops count each entry
    once through T (`k10_ops`); bytes what the stages read of the real
    groups' H and R rows (the patch blocks: H_i's self-quadrants; the pair
    blocks: all of H_i; R_i's nonzero half), the tables and the output
    once. The parent's count (`bound_ms_full`): per local
    pair the 25 element jet pairs over Q qps, and per real interface qp 9
    jet pairs over the (2L)^2 pairs of a pair block or the two L x L
    quadrants of a patch block."""
    from goldfish_tpu_torch.solver import krylov, system

    ps = krylov.PairSchwarz(data)
    patches = krylov._block_tables(data)
    tables = ps.tables
    Hs = system.jet_hessians(data, d, cp, h)
    _, Q, _, L = tables.R_e.shape
    Li = tables.R_i.shape[-1] // 2
    P, n = patches.free.shape

    def plain(bt):
        def fn():
            Kp = torch.empty(P, n, n, dtype=torch.float64, device=cp.device)
            krylov._patch_assemble_plain(Kp, bt, tables, Hs)
            if bt.pair is None:
                return Kp
            out = torch.empty(bt.pa.shape[0], 2 * n, 2 * n,
                              dtype=torch.float64, device=cp.device)
            krylov._pair_assemble_plain(out, Kp, bt, tables, Hs)
            return out
        return fn

    ge = torch.nonzero(data.stack.wq.reshape(-1, Q).sum(-1) > 0)[:, 0]
    gi = torch.nonzero(data.ifs.w.reshape(-1) > 0)[:, 0]
    Hi, Ri = Hs[1][gi], tables.R_i[gi]
    # R_i's rows on side A are zero on B's locals and the other way round:
    # no stage reads those halves
    ri = [Ri[..., :3, :Li], Ri[..., 3:, Li:]]
    el = [Hs[0][ge], tables.R_e[ge]]
    if Hs[2] is not None:
        el += [Hs[2][ge], tables.R_p[ge]]
    cases = {}
    for name, bt in (("pair_assemble/patches", patches),
                     ("pair_assemble/pairs", ps.blocks)):
        ops = k10_ops(bt.patch, L, Li)
        ipairs = 4 * Li * Li // 2
        # stage 1 reads H_i's two self-quadrants, stage 2 the cross ones
        hi = [Hi[..., :9, :9], Hi[..., 9:, 9:]]
        if bt.pair is not None:
            ops += k10_ops(bt.pair, L, Li)
            ipairs = 4 * Li * Li
            hi = [Hi]
        full = 18 * (len(ge) * L * L * Q * 25 + len(gi) * ipairs * 9)
        ins = [*el, *hi, *ri, bt.free,
               *(t for t in (bt.pa, bt.pb) if t is not None),
               *(t for be in (bt.patch, bt.pair) if be is not None
                 for t in (be.kind, be.group, be.nq, be.cps, be.band_ptr,
                           be.band_ent))]
        cases[name] = (lambda bt=bt: krylov.assemble_blocks(bt, tables, Hs),
                       plain(bt), ops, ins, PEAK_F64_TC,
                       {"flops_full": full})
    return cases, ps, patches


def phase_pegasus_kernels(s, checks, seed=9):
    """K10 (patches, pairs) and K1-K4 at the full box wing's shapes, d at
    1e-3 of the CP scale on free dofs (seeded), lam and v random; K10's
    blocks must be the same bits over 5 launches (no atomics)."""
    dev = s.cp.device
    rng = np.random.default_rng(seed)
    cp, h = s.cp, s.h_init
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * s.data.free
    lam = T(rng.normal(size=tuple(cp.shape))) * s.data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    cases, ps, patches = pair_cases(s.data, d, cp, h)
    for tag, be, n_dest in (("patches", patches.patch, ps.P),
                            ("pairs", ps.blocks.pair, 2 * ps.I)):
        say(f"[pegasus-kernel] K10 {tag}: {be.kind.numel()} entries, "
            f"{n_dest} x {be.n_bands} bands of {be.band_rows} rows, "
            f"{be.band_ent.numel()} band entries")
    say(f"[pegasus-kernel] pair-Schwarz: {ps.I} pairs in {len(ps.colors)} "
        f"colours {[len(c) for c in ps.colors]}")
    for name, got in check_kernels(cases, "pegasus-kernel",
                                   tol=K10_TOL).items():
        merge(checks, name, got)
    for name, (kern, *_) in cases.items():
        first = kern()
        same = all(torch.equal(kern(), first) for _ in range(4))
        say(f"[pegasus-kernel C2] {name}: blocks over 5 launches "
            f"bit-identical {same}")
        if not same:
            raise RuntimeError(f"{name}: its blocks change from launch to "
                               "launch")
    for name, got in check_kernels(fixed_cases(s.data, d, cp, h, lam, v,
                                               "pegasus-kernel"),
                                   "pegasus-kernel").items():
        merge(checks, name, got, "pegasus")


def phase_pegasus_dense(dev, ref):
    """The demo's problem on the persistent Cholesky factor: cold J and
    gradient from d = 0, then 3 warm 1e-4 steps (secant warm start)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import pegasus_thickness_opt as demo
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart

    ns = demo.setup(**PEG, route="dense", device=dev)
    s, fac = ns.sys, ns.solve.device_factor
    reset_counts()
    x0 = np.asarray(ns.x0)
    J, g, d, dt = evaluate(ns.obj, "h_ffd", x0, s.zero_displacement(), dev)
    check_cold("pegasus-dense", J, g, dt, ref["ffd"], key="grad")
    ws = SecantWarmStart()
    xt0 = torch.tensor(x0, dtype=torch.float64)
    ws.update(xt0, d)
    warm = []
    for k in range(1, 4):
        xk = xt0 * (1.0 + 1e-4 * k)
        Jk, _, d, dtk = evaluate(ns.obj, "h_ffd", xk.numpy(),
                                 ws.predict(xk, d), dev)
        ws.update(xk, d)
        warm.append(dtk)
        say(f"[pegasus-dense] warm step {k}/3 {dtk:.3f} s J={Jk!r} newton "
            f"its {ns.solve.solver.last_its}")
    counts = dict(_cuda.launch_counts)
    say_shapes("pegasus-dense")
    say(f"[pegasus-dense] warm median {float(np.median(warm)):.3f} s; "
        f"n_factor {fac.n_factor} (failed {fac.n_factor_failed}); "
        f"refactor_log {fac.refactor_log}")
    check_counts("pegasus-dense", counts, WING_KERNELS + CHOL)
    return counts, fac


def gmres_probe(ns, dev):
    """One GMRES-IR pass (restart 32, rtol 1e-8) on the cold Newton system
    K(0) x = -r(0) of the box wing with each preconditioner: pair-Schwarz
    and patch blocks (K10; at most 4 restart cycles) and the dense f64 LU
    (16). Prints the set-up and solve seconds, the cycles and the final
    |K x + r| / |r|; returns the pair-Schwarz factors for the library
    timings."""
    from goldfish_tpu_torch.solver import krylov, system

    s = ns.sys
    data, cp, h = s.data, s.cp, s.h_init
    d = s.zero_displacement()
    ps = ns.solve.solver.schwarz or krylov.PairSchwarz(data)
    tables = ps.tables
    Hs = system.jet_hessians(data, d, cp, h)
    _, r = system.potential_and_residual(data, d, cp, h)
    op = lambda v: system.tangent_matvec_from(tables, Hs, v)  # noqa: E731
    out = {}
    for name, make, cap in (
            ("pair_schwarz", lambda: (ps, ps.assemble(data, d, cp, h,
                                                      Hs=Hs)), 4),
            ("patch_block", lambda: krylov.patch_block_precond(
                data, d, cp, h, tables=tables, Hs=Hs), 4),
            ("full", lambda: krylov.full_precond(data, d, cp, h,
                                                 tables=tables, Hs=Hs), 16)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = make()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x, cyc = krylov._gmres_ir(op, krylov._mop(pre, op), -r, 1e-8, 32,
                                  cap, 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = float(torch.linalg.norm(op(x) + r) / torch.linalg.norm(r))
        if not np.isfinite(res):
            raise RuntimeError(f"GMRES with {name}: non-finite residual")
        say(f"[pegasus-gmres] {name:12s} set-up {t1 - t0:.3f} s, GMRES "
            f"{t2 - t1:.3f} s over {cyc} restart cycles: |Kx + r|/|r| "
            f"{res:.3e}")
        out[name] = pre
    out["Hs"] = Hs
    say(f"[pegasus-gmres] pair-Schwarz apply: {len(ps.colors)} colours "
        f"(pairs per colour {[len(c) for c in ps.colors]}), "
        f"{len(ps.colors) - 1} K4 matvecs between them")
    return out


def time_library_pegasus(pre, n_dof, reps=3):
    """The library calls of the matrix-free path, with CUDA events on the
    cold state's matrices: the batched f64 LU of the equilibrated pair
    blocks and the batched lu_solve of one colour
    (bounds: the larger of moving the blocks once, and 2/3 n^3 per block
    over the f64 tensor-core rate; the solve: its factors once over the
    memory rate), the dense f64 LU of K (2/3 N^3) and its one-RHS solve (2
    N^2 8 B), and the Arnoldi projection V v of a 33-vector basis."""
    from goldfish_tpu_torch.solver import krylov, system

    ps, fac = pre["pair_schwarz"]
    lu, piv = fac[0], fac[1]
    B, nb = lu.shape[0], lu.shape[1]

    def equilibrated(K):
        dsc = torch.rsqrt(K.diagonal(dim1=-2, dim2=-1).abs() + 1e-300)
        return K.mul_(dsc[..., :, None]).mul_(dsc[..., None, :])

    Kb = equilibrated(krylov.assemble_blocks(ps.blocks, ps.tables,
                                             pre["Hs"]))
    rows = []
    tb = 2 * B * nb * nb * 8 / PEAK_BYTES * 1e3
    tf = B * 2 * nb ** 3 / 3 / PEAK_F64_TC * 1e3
    rows.append(dict(name="batched lu_factor_ex (pair blocks)",
                     path="pegasus91", n=f"{B}x{nb}", ms=cuda_ms(
                         lambda: torch.linalg.lu_factor_ex(Kb), reps),
                     bound_ms=max(tb, tf),
                     bound_by="bytes" if tb >= tf else "operations"))
    k1 = len(ps.colors[0])
    rhs = torch.randn(k1, nb, 1, dtype=torch.float64, device=lu.device)
    rows.append(dict(name="batched lu_solve (one colour)", path="pegasus91",
                     n=f"{k1}x{nb}", ms=cuda_ms(lambda: torch.linalg.lu_solve(
                         lu[:k1], piv[:k1], rhs), 10),
                     bound_ms=k1 * nb * nb * 8 / PEAK_BYTES * 1e3,
                     bound_by="bytes"))
    del Kb
    flu, fpiv, _ = pre["full"][1]
    Kf = equilibrated(system.assemble_K_from(ps.tables, pre["Hs"]))
    rows.append(dict(name="lu_factor_ex (dense K)", path="pegasus91",
                     n=n_dof, ms=cuda_ms(lambda: torch.linalg.lu_factor_ex(Kf),
                                         reps),
                     bound_ms=2 * n_dof ** 3 / 3 / PEAK_F64_TC * 1e3,
                     bound_by="operations"))
    del Kf
    b = torch.randn(n_dof, 1, dtype=torch.float64, device=flu.device)
    rows.append(dict(name="lu_solve (dense K, 1 RHS)", path="pegasus91",
                     n=n_dof, ms=cuda_ms(lambda: torch.linalg.lu_solve(
                         flu, fpiv, b), 10),
                     bound_ms=2 * n_dof * n_dof * 8 / PEAK_BYTES * 1e3,
                     bound_by="bytes"))
    V = torch.randn(33, n_dof, dtype=torch.float64, device=flu.device)
    v = torch.randn(n_dof, dtype=torch.float64, device=flu.device)
    rows.append(dict(name="Arnoldi projection V @ v", path="pegasus91",
                     n=f"33x{n_dof}", ms=cuda_ms(lambda: V @ v, 10),
                     bound_ms=33 * n_dof * 8 / PEAK_BYTES * 1e3,
                     bound_by="bytes"))
    for row in rows:
        say(f"[library] {json.dumps(row)}")
    return rows


def phase_pegasus_krylov(dev, ref):
    """The demo's Newton-Krylov route: first the GMRES probe of the three
    preconditioners, counted on its own (the only run that launches K10:
    the route itself runs on the dense LU); then, with the counts reset,
    the main path: the cold evaluation of both parametrizations against the
    dense reference and run_slsqp(maxiter=3). Returns the main path's
    counts, the probe's, the probe's factors and N."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import pegasus_thickness_opt as demo

    ns = demo.setup(**PEG, route="krylov", device=dev)
    s = ns.sys
    sv = ns.solve.solver
    reset_counts()
    pre = gmres_probe(ns, dev)
    probe = dict(_cuda.launch_counts)
    say_shapes("pegasus-probe")
    check_counts("pegasus-probe", probe, PEG_PROBE_KERNELS)
    reset_counts()
    x0 = np.asarray(ns.x0)
    J0, g, d, dt = evaluate(ns.obj, "h_ffd", x0, s.zero_displacement(), dev)
    say(f"[pegasus-krylov] cold Newton (it, |r|, alpha, GMRES cycles) "
        f"{sv.last_log}; adjoint cycles {sv.adjoint_cycles[-1]}")
    check_cold("pegasus-krylov", J0, g, dt, ref["ffd"], 1e-10, 1e-5, "grad")
    nc = demo.setup(**PEG, const_th=True, route="krylov", device=dev)
    Jc, gc, _, dtc = evaluate(nc.obj, "h_ffd", np.asarray(nc.x0),
                              s.zero_displacement(), dev)
    check_cold("pegasus-krylov const-th", Jc, gc, dtc, ref["const_th"],
               1e-10, 1e-5, "grad")
    del nc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=3, tol=1e-12)
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say_shapes("pegasus-krylov")
    with torch.no_grad():
        V1 = float(ns.vol({"h_ffd": torch.tensor(res.x["h_ffd"],
                                                 dtype=torch.float64,
                                                 device=dev)}))
    eV = abs(V1 - ns.V0) / ns.V0
    wf, wj = ns.prob.eval_wall["fun"], ns.prob.eval_wall["jac"]
    say(f"[pegasus-krylov] slsqp {wall:.2f} s: nit {res.nit} nfev {res.nfev} "
        f"njev {res.njev}; W_int per iteration {res.history} final "
        f"{res.fun!r} (start {J0!r}); volume rel change {eV:.2e}; "
        f"{res.message}")
    say(f"[pegasus-krylov] wall per fun median {float(np.median(wf)):.3f} s "
        f"(n {len(wf)}, max {max(wf):.3f}); per jac median "
        f"{float(np.median(wj)):.3f} s (n {len(wj)}, max {max(wj):.3f}); "
        f"last Newton {sv.last_log}; adjoint cycles {sv.adjoint_cycles}")
    if not (np.isfinite(res.fun) and res.fun < J0 and res.nit >= 1
            and eV <= 1e-9):
        raise RuntimeError(f"pegasus SLSQP did not lower W_int ({res.fun!r} "
                           f"vs {J0!r}) or broke the volume ({eV:.2e})")
    check_counts("pegasus-krylov", counts, WING_KERNELS)
    return counts, probe, pre, s.cp.numel()


# ------------------------------------------------------------ VLM, roof
def vlm_cases(corners, seed):
    """K11 in both modes on the panels of a corner grid: name -> (kernel
    fn, plain fn, flops, inputs). Bounds: the value's AIC_OPS per pair;
    the VJP's reverse sweep, SWEEP_AIC per pair, and beside it the
    yardstick of the dual-number kernel it replaced, 4 AIC_OPS per pair
    (`bound_ms_dual`)."""
    from goldfish_tpu_torch.physics import vlm

    A, B, colloc, nhat, _ = vlm.panel_geometry(corners)
    io = [colloc.contiguous(), nhat.contiguous(), A.contiguous(),
          B.contiguous(), vlm.wake_direction(corners.device)]
    N = colloc.shape[0]
    g = torch.tensor(np.random.default_rng(seed).normal(size=(N, N)),
                     device=corners.device)
    return {
        "vlm_aic/value": (lambda: vlm.aic_value(*io),
                          lambda: vlm.aic_plain(*io), N * N * AIC_OPS, io),
        "vlm_aic/vjp": (lambda: vlm.aic_vjp(*io, g),
                        lambda: vlm.aic_vjp_plain(*io, g),
                        N * N * SWEEP_AIC, io + [g],
                        {"flops_dual": 4 * N * N * AIC_OPS}),
    }


def phase_vlm_kernels(coupled, checks, seed=12):
    """K11 on the full-width lattice and on the demo's, at the deformed
    corners of a seeded d (1e-3 of the CP scale on free dofs); K5 at each
    lattice's corners (the full width's 17 x 65 = 1105 points)."""
    from goldfish_tpu_torch.ops import bspline_traced as bt
    from goldfish_tpu_torch.physics import vlm

    for tag, (J_of_h, s, _) in coupled.items():
        kw = VLM_WIDE if tag == "wing20" else VLM_DEMO
        ss, (p, q) = bt.make_surf_set(s.surfs, device=s.cp.device)
        lat = vlm.build_lattice_param(kw["n_chord"], kw["n_span"], kw["mc"],
                                      kw["ns"], device=s.cp.device)
        case = rows_case(ss, p, q, lat.ip.reshape(-1).contiguous(),
                         lat.xi.reshape(-1, 2).contiguous())
        got = check_kernels({"traced_rows": case}, f"vlm-kernel {tag} "
                            f"lattice rows", tol=FUSED_TOL)
        merge(checks, "traced_rows", got["traced_rows"],
              "vlm" if tag == "wing20" else "vlm_demo")
        rng = np.random.default_rng(seed)
        cp = s.cp
        scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
        d = torch.tensor(1e-3 * scale * rng.normal(size=tuple(cp.shape)),
                         device=cp.device) * s.data.free
        corners = J_of_h.corners(d)
        say(f"[vlm-kernel {tag}] lattice {tuple(corners.shape[:2])}, "
            f"{(corners.shape[0] - 1) * (corners.shape[1] - 1)} panels")
        got = check_kernels(vlm_cases(corners, seed), f"vlm-kernel {tag}",
                            tol=VLM_TOL)
        for name, case in got.items():
            merge(checks, name, case, None if tag == "wing20" else tag)


def check_vlm(tag, J, lift, tip, g, ref):
    """Raise unless W_int and lift (1e-8), the tip displacement and
    dW_int/dh (1e-6) agree with the reference `ref`. The tip is a
    displacement: both Newton solves stop at |r| ~ 1e-9 |r(0)|, which
    leaves it ~5e-8 apart at the demo's size (a CPU run of both), where the
    energy-like W_int and lift agree to ~1e-12."""
    eJ = abs(J - ref["J"]) / abs(ref["J"])
    eL = abs(lift - ref["lift"]) / abs(ref["lift"])
    eT = rel_err(torch.as_tensor(tip), torch.tensor(ref["tip"]))[0]
    eg = rel_err(g.cpu(), torch.tensor(ref["dW_dh"]))[0]
    say(f"[{tag}] W_int={J!r} (ref {ref['J']!r}, rel {eJ:.2e}) lift="
        f"{lift!r} (rel {eL:.2e}) tip u_z={float(tip[2])!r} (tip rel "
        f"{eT:.2e}) |dW_int/dh| rel {eg:.2e}")
    if not (eJ <= 1e-8 and eL <= 1e-8 and eT <= 1e-6 and eg <= 1e-6):
        raise RuntimeError(f"{tag} disagrees with the JAX CPU reference: J "
                           f"{eJ:.2e}, lift {eL:.2e}, tip {eT:.2e}, "
                           f"gradient {eg:.2e}")


def phase_vlm_demo(dev, ref):
    """The demo's `main` at its defaults: the cold coupled gradient and the
    demo's own FD check (it asserts rel < 1e-5)."""
    from goldfish_tpu_torch.demos import vlm_aeroelastic_wing as demo

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    J, lift, tip, g, fd_rel, _ = demo.main(**VLM_DEMO, n_fp=4, device=dev)
    torch.cuda.synchronize()
    say(f"[vlm-demo] main (cold gradient + FD) {time.perf_counter() - t0:.3f}"
        f" s; FD rel {fd_rel:.2e} (ref's {ref['fd']['rel']:.2e})")
    check_vlm("vlm-demo", J, lift, tip, g, ref)


def phase_vlm_wide(coupled, ref):
    """The coupled evaluation at full width: cold with its gradient and FD
    check, then 3 warm evaluations at h0 + k 1e-4 v from the previous d."""
    from goldfish_tpu_torch.demos import vlm_aeroelastic_wing as demo

    J_of_h, s, h0 = coupled
    its = J_of_h.solve.solver.its_log
    fac = J_of_h.solve.device_factor
    d0 = s.zero_displacement()

    def evaluate(h, d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J, d, lift, g = demo.coupled_gradient(J_of_h, h, d)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (bool(torch.isfinite(J)) and bool(torch.isfinite(d).all())
                and bool(torch.isfinite(g).all()) and g.shape == h0.shape
                and d.shape == s.cp.shape):
            raise RuntimeError("non-finite or misshapen coupled evaluation")
        return float(J), d, float(lift), g, dt

    J, d, lift, g, dt = evaluate(h0, d0)
    tip = s.evaluate_displacement(d, s.num_splines - 1, [0.5, 1.0])
    say(f"[vlm-wide] cold coupled evaluation {dt:.3f} s, newton its per pass"
        f" {its}, n_factor {fac.n_factor}")
    check_vlm("vlm-wide", J, lift, tip, g, ref)
    t0 = time.perf_counter()
    ad, fd, fd_rel = demo.fd_check(J_of_h, s, h0, d0, g)
    say(f"[vlm-wide] FD check ad={ad!r} fd={fd!r} rel {fd_rel:.2e} (ref's "
        f"{ref['fd']['rel']:.2e}), {time.perf_counter() - t0:.3f} s")
    if not fd_rel < 1e-5:
        raise RuntimeError(f"vlm-wide FD check: rel {fd_rel:.2e}")
    v = demo.fd_direction(s, h0)
    warm = []
    for k in range(1, 4):
        n0, nf = len(its), fac.n_factor
        Jk, d, _, _, dt = evaluate(h0 + 1e-4 * k * v, d)
        warm.append(dt)
        say(f"[vlm-wide] warm evaluation {k}/3 {dt:.3f} s W_int={Jk!r} "
            f"newton its per pass {its[n0:]}, factorizations "
            f"{fac.n_factor - nf}")
    say(f"[vlm-wide] warm median {float(np.median(warm)):.3f} s; n_factor "
        f"{fac.n_factor} (failed {fac.n_factor_failed}); refactor_log "
        f"{fac.refactor_log}")
    return d


def time_aic_solve(J_of_h, d, reps=10):
    """The library call of the VLM path: Gamma = linalg.solve(AIC, rhs) at
    the state d, with CUDA events; bound 2N^3/3 f64 operations over the f64
    tensor-core rate."""
    from goldfish_tpu_torch.physics import vlm

    A, B, colloc, nhat, _ = vlm.panel_geometry(J_of_h.corners(d))
    with torch.no_grad():
        M = vlm.aic(colloc, nhat, A, B, vlm.wake_direction(d.device))
    rhs = -nhat[:, 2].contiguous()
    N = M.shape[0]
    row = dict(name="AIC linalg.solve", path="vlm_wing20", n=N,
               ms=cuda_ms(lambda: torch.linalg.solve(M, rhs), reps),
               bound_ms=2 * N ** 3 / 3 / PEAK_F64_TC * 1e3,
               bound_by="operations")
    say(f"[library] {json.dumps(row)}")
    return [row]


def path_kernels(s, d, checks, tag, suffix, seed):
    """K1-K4 (K2 where there are interfaces) at a path's shapes against
    their plain versions, merged into `checks` with their times as
    *_<suffix>: at phase 3's kind of state (d random at 1e-3 of the CP
    scale on free dofs, seeded; lam, v random). Printed, not gated
    (ROADMAP C6): K1 mode a at the path's own d (plus 1e-3 of its largest
    entry as noise) four ways, the kernel, the plain version, the
    cancellation-free evaluation (`kl_shell.shell_density_increments`) and
    the plain version at x = cp + d moved by one ulp of x, with their
    pairwise gaps, and the plain version at d moved by one ulp of d: near a
    linear-regime solution the strains are small differences of large
    metrics, so every f64 evaluation of the plain form carries a rounding
    of about the kernel-vs-plain gap."""
    from goldfish_tpu_torch.physics import kl_shell

    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(a, dtype=torch.float64,  # noqa: E731
                               device=d.device)
    free, cp, h = s.data.free, s.cp, s.h_init
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    dn = T(1e-3 * scale * rng.normal(size=tuple(d.shape))) * free
    lam = T(rng.normal(size=tuple(d.shape))) * free
    v = T(rng.normal(size=tuple(d.shape)))
    for name, got in check_kernels(fixed_cases(s.data, dn, cp, h, lam, v,
                                               tag), tag).items():
        merge(checks, name, got, suffix)
    de = d + T(1e-3 * float(d.abs().max())
               * rng.normal(size=tuple(d.shape))) * free
    sign = T(rng.choice([-1.0, 1.0], size=tuple(d.shape)))
    st, E, nu = s.stack, s.data.E, s.data.nu
    got = {
        "kernel": kl_shell.shell_value_grad(st, de, cp, h, E, nu),
        "plain": kl_shell._value_grad_plain(st, de, cp, h, E, nu),
        "cancellation-free": kl_shell._value_grad_plain(
            st, de, cp, h, E, nu, density=kl_shell.shell_density_increments),
        "plain x-ulp": kl_shell._value_grad_plain(
            st, de + (cp + de) * 2.2e-16 * sign, cp, h, E, nu),
    }
    u = kl_shell._value_grad_plain(st, de * (1.0 + 2.2e-16 * sign), cp, h,
                                   E, nu)

    def worst(a, b):
        return max(rel_err(x, y)[0] for x, y in zip(a, b))

    names = list(got)
    gaps = "; ".join(f"{a} vs {b} {worst(got[a], got[b]):.3e}"
                     for i, a in enumerate(names) for b in names[i + 1:])
    say(f"[{tag} own-d] shell_qp/value_grad, relative in norm (worst of W, "
        f"r, dW/dh): {gaps}; plain vs plain at d moved by one ulp of d "
        f"{worst(u, got['plain']):.3e} (not gated)")


def phase_slr(dev, ref, checks):
    """The Scordelis-Lo roof at num_el=6: the linear-regime QoI and the
    interface continuity of the reference's test_slr.py; then K1-K4 at its
    shapes."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import slr

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qoi, d, s = slr.solve_qoi(num_el=ref["num_el"],
                              load_scale=ref["load_scale"], device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say_shapes("slr")
    e_pub = abs(qoi - slr.QOI_REF) / slr.QOI_REF
    e_ref = abs(qoi - ref["qoi"]) / ref["qoi"]
    scale = ref["load_scale"]
    uA = s.evaluate_displacement(d, 0, [1.0, 0.7]) / scale
    uB = s.evaluate_displacement(d, 1, [0.0, 0.7]) / scale
    jump = float(np.linalg.norm(uA - uB) / max(np.linalg.norm(uA), 1e-12))
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[slr] num_el={ref['num_el']} P={P} C={C} N={P * C * 3}: QoI "
        f"{qoi!r} (published {slr.QOI_REF}, rel {e_pub:.2e}, gate 5e-3; JAX "
        f"{ref['qoi']!r}, rel {e_ref:.2e}, gate 1e-8), interface jump "
        f"{jump:.2e} (gate 1e-5), {dt:.3f} s")
    if not (e_pub < 5e-3 and e_ref <= 1e-8 and jump < 1e-5):
        raise RuntimeError(f"slr: QoI {qoi!r} or interface jump {jump:.2e} "
                           f"out of its gate")
    check_counts("slr", counts, SLR_KERNELS)
    path_kernels(s, d, checks, "slr-kernel", "slr", 23)
    return counts


# ------------------------------------------------------------ press, Riks
def press_problem(num_el, dev, p=2, q=120.0, k_pen=1e7):
    """tests/test_contact.py's two-plate press (the JAX package has no model
    for it): a plate at z = 0.12 under q pressed onto one at z = 0, both
    clamped on two sides (two CP layers), contact (0, 1) with r_max 0.1."""
    from goldfish_tpu_torch.geometry.cadkit import bilinear
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    def plate_at(z):
        srf = bilinear([0, 0, z], [1, 0, z], [0, 1, z], [1, 1, z])
        srf = srf.elevate(0, p - 1).elevate(1, p - 1)
        nk = np.linspace(0, 1, num_el + 1)[1:-1]
        return srf.refine(0, nk).refine(1, nk)

    s = NonMatchingSystem([plate_at(0.12), plate_at(0.0)], E=1e7, nu=0.3,
                          h_th=0.01, device=dev)
    for side in (0, 1):
        s.add_side_bc(0, direction=1, side=side, n_layers=2)
        s.add_side_bc(1, direction=1, side=side, n_layers=2)
    s.set_dead_load([[0, 0, -q], [0, 0, 0]])
    s.set_contact([(0, 1)], k_pen=k_pen, r_max=0.1)
    return s


def riks_panel(num_el, dev, p=2):
    """tests/test_riks.py's shallow cylindrical panel (R 2540, L 508, half
    angle 0.1): straight edges hinged, a centre point load of 4000."""
    from goldfish_tpu_torch.geometry.cadkit import circle, extrude
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    arc = circle(radius=2540.0, angle=(np.pi / 2 - 0.1, np.pi / 2 + 0.1))
    srf = extrude(arc, (0.0, 0.0, 508.0)).elevate(0, p - 2).elevate(1, p - 1)
    kn = np.linspace(0, 1, num_el + 1)[1:-1]
    srf = srf.refine(0, kn).refine(1, kn)
    s = NonMatchingSystem([srf], 3102.75, 0.3, 12.7, device=dev)
    s.add_side_bc(0, direction=0, side=0, n_layers=1)
    s.add_side_bc(0, direction=0, side=1, n_layers=1)
    s.add_point_load(0, [0.5, 0.5], [0.0, -4000.0, 0.0])
    return s


def press_path(s):
    """The press path of tests/test_contact.py: continuation (4 levels, rtol
    1e-9, max_it 40) from d = 0 on one persistent factor, then
    `build_solve_fn(rtol=1e-10, max_it=60)` warm at the equilibrium, J =
    W_int with dJ/dh by the adjoint, and the central difference along the
    test's seeded v (eps 1e-6)."""
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.physics.contact import contact_energy
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.implicit import (
        build_solve_fn,
        continuation_solve,
    )
    from goldfish_tpu_torch.solver.system import residual

    data = s.data
    fac = PersistentDeviceFactor(data)
    levels = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, _, rn = continuation_solve(data, s.cp, s.h_init, s.zero_displacement(),
                                  n_steps=4, rtol=1e-9, max_it=40, fac=fac,
                                  log=levels)
    torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    r0 = float(torch.linalg.norm(residual(data, torch.zeros_like(d), s.cp,
                                          s.h_init)))
    solve = build_solve_fn(data, rtol=1e-10, max_it=60)

    def J_of_h(h):
        dd = solve(s.cp, h, d)
        return kl_shell.internal_energy(s.stack, dd, s.cp, h, s.E, s.nu)

    h0 = s.h_init.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    J = J_of_h(h0)
    J.backward()
    torch.cuda.synchronize()
    t_adj = time.perf_counter() - t0
    g = h0.grad.detach()
    v = torch.tensor(np.random.default_rng(3).normal(size=tuple(g.shape)),
                     device=g.device) * s.stack.cp_mask
    with torch.no_grad():
        Jp, Jm = (float(J_of_h(s.h_init + e * 1e-6 * v)) for e in (1.0, -1.0))
    fd = (Jp - Jm) / 2e-6
    ad = float((g * v).sum())
    return dict(d=d, rn=float(rn), r0=r0, J=float(J.detach()), g=g.cpu(),
                W_c=float(contact_energy(data.contact, s.stack, d, s.cp)),
                mid=float(s.evaluate_displacement(d, 0, [0.5, 0.5])[2]),
                fd_rel=abs(ad - fd) / abs(fd), t_cont=t_cont, t_adj=t_adj,
                levels=levels, fac=fac)


def contact_cases(s, d, seed):
    """K12's cull and three modes at the press s's state d, with cells the
    elements as on the main path: name -> (kernel fn, plain fn, flops,
    inputs[, extra]). value_grad builds its own list (as `contact_energy`
    does); hvp and hess take one built at this state (as the tangent's K_c
    v and assembly do). The flops count the qp pairs within r_max (and, for
    the hess mode, the element pairs holding one): the work this state
    needs; the cull's, its tests. Prints the element pairs the cull listed
    beside its plain twin's count (also with 16-qp cells) and raises if
    the lists differ."""
    from goldfish_tpu_torch.physics import contact as pc
    from goldfish_tpu_torch.solver import system

    c = s.data.contact
    x, w = (t.contiguous() for t in pc.contact_qps(s.stack, d, s.cp))
    rng = np.random.default_rng(seed)
    v = torch.tensor(rng.normal(size=tuple(x.shape)), device=x.device)
    # mode 3's (dx, dw): the qp values and weight tangent of a seeded cp
    # tangent, as `contact_design_jvp` forms them
    tcp = torch.tensor(rng.normal(size=tuple(s.cp.shape)), device=x.device)
    dx = pc.qp_field(s.stack, tcp).contiguous()
    dw = pc.qp_weights_jvp(s.stack, s.cp, tcp).contiguous()
    tabs = system.jet_tables(s.data)
    G, Q, _, L = tabs.R_c.shape
    P = x.shape[0]
    E = G // P
    N = tabs.free.shape[0]
    n_pairs = n_elem = 0
    for *_, dphi, _, ww in pc._pairs(c, x, w, align=Q):
        act = (dphi != 0) & (ww != 0)
        n_pairs += int(act.sum())
        n_elem += int(act.reshape(-1, Q, E, Q).any(3).any(1).sum())
    cells = pc.contact_cells(c, x, w, Q)

    def listed(cl):
        return torch.sort(cl.index[:int(cl.count)].long()).values

    def compare(a, b):
        got = listed(a)
        if got.numel() != b.numel():
            raise RuntimeError(f"cull lists {got.numel()} element pairs, "
                               f"its plain twin {b.numel()}")
        diff = (got - b).abs()
        if not diff.numel():
            return 0.0, 0.0
        return float((diff != 0).double().mean()), float(diff.max())

    def hess(fn, **kw):
        K = torch.zeros(N, N, dtype=torch.float64, device=x.device)
        S = fn(K, c, x, w, tabs.R_c, tabs.gi_e, tabs.free, **kw)
        return S, K

    ops = CONTACT_OPS
    io = [x, w, c.pa, c.pb, c.k_pen, c.r_max]
    cases = {
        "contact_pairs/cull": (
            lambda: pc.contact_cells(c, x, w, Q),
            lambda: pc.candidate_pairs(c, x, w, Q),
            c.pa.numel() * E * E * CULL_OPS_PAIR + P * E * Q * CULL_OPS_QP,
            io, {"compare": compare, "outputs": lambda a: a.index[
                :int(a.count)]}),
        "contact_pairs/value_grad": (
            lambda: pc.contact_value_grad(c, x, w, q=Q),
            lambda: pc._value_grad_plain(c, x, w),
            n_pairs * ops["contact_pairs/value_grad"], io),
        "contact_pairs/hvp": (
            lambda: pc.contact_hvp(c, x, w, v, cells=cells),
            lambda: pc._hvp_plain(c, x, w, v),
            n_pairs * ops["contact_pairs/hvp"], io + [v]),
        "contact_pairs/hess": (
            lambda: hess(pc.contact_hess, cells=cells),
            lambda: hess(pc._hess_plain),
            n_pairs * ops["contact_pairs/hess"]
            + n_elem * 2 * 9 * Q * L * (Q + L),
            io + [tabs.R_c, tabs.gi_e, tabs.free]),
        "contact_pairs/design_fwd": (
            lambda: pc.contact_force_jvp(c, x, w, dx, dw, cells=cells),
            lambda: pc._design_jvp_plain(c, x, w, dx, dw),
            n_pairs * ops["contact_pairs/design_fwd"], io + [dx, dw]),
    }
    # the element pairs that ran, counted by the kernels, against the twin
    runs = {}
    for mode in ("value_grad", "hess"):
        n = torch.zeros(1, dtype=torch.int32, device=x.device)
        if mode == "value_grad":
            pc.contact_value_grad(c, x, w, active=n, q=Q)
        else:
            hess(pc.contact_hess, active=n)
        runs[mode] = int(n)
    total = c.pa.numel() * E * E
    twin = pc.candidate_pairs(c, x, w, Q).numel()
    n16 = int(pc.contact_cells(c, x, w).count)
    twin16 = pc.candidate_pairs(c, x, w).numel()
    say(f"[contact-kernel] qp pairs within r_max {n_pairs} of "
        f"{c.pa.numel() * w.shape[1] ** 2}, element pairs holding one "
        f"{n_elem}; the cull listed {int(cells.count)} of {total} element "
        f"pairs (plain twin {twin}), dropped {1 - twin / total:.4f}; "
        f"element pairs run: value_grad {runs['value_grad']}, hess "
        f"{runs['hess']}; with 16-qp cells {n16} (plain twin {twin16}) of "
        f"{c.pa.numel() * (-(-w.shape[1] // 16)) ** 2}")
    if not (int(cells.count) == twin == runs["value_grad"] == runs["hess"]
            and n16 == twin16 and twin >= n_elem):
        raise RuntimeError("K12's cull disagrees with its plain twin")
    return cases, (x, w)


def check_contact(s, d, tag, seed=20):
    """K12 against its plain versions at state d + seeded noise (1e-3 of
    max |d| on free dofs); W_c itself to 1e-12. Returns the checked
    cases."""
    from goldfish_tpu_torch.physics import contact as pc

    rng = np.random.default_rng(seed)
    dn = d + 1e-3 * float(d.abs().max()) * torch.tensor(
        rng.normal(size=tuple(d.shape)), device=d.device) * s.data.free
    cases, (x, w) = contact_cases(s, dn, seed)
    got = check_kernels(cases, tag, reps=3, tol=CONTACT_TOL)
    c = s.data.contact
    W = float(pc.contact_value_grad(c, x, w)[0])
    Wp = float(pc._value_grad_plain(c, x, w)[0])
    eW = abs(W - Wp) / abs(Wp)
    say(f"[{tag}] W_c {W!r} plain {Wp!r} rel {eW:.3e} (gate 1e-12)")
    if not (Wp > 0 and eW <= 1e-12):
        raise RuntimeError(f"{tag}: W_c {W!r} vs plain {Wp!r} (rel "
                           f"{eW:.3e}) or not contact-active")
    return got


def phase_contact_kernels(dev):
    """K12 at the num_el=16 press's continuation equilibrium plus noise;
    returns the checked cases (merged after the main path's own)."""
    from goldfish_tpu_torch.solver.implicit import continuation_solve

    s = press_problem(16, dev)
    P, C = s.stack.n_patches, s.stack.max_cp
    d, _, _ = continuation_solve(s.data, s.cp, s.h_init,
                                 s.zero_displacement(), n_steps=4, rtol=1e-9,
                                 max_it=40)
    say(f"[setup] press num_el=16: P={P} C={C} N={P * C * 3} stack "
        f"{tuple(s.stack.R00.shape)}")
    return check_contact(s, d, "contact-kernel press16")


def phase_press(dev, checks, ref, got16):
    """The counted press path at num_el=32, K12 at its shapes (the kernels
    line's times; num_el=16's `got16` add theirs as *_press16), then the
    same path at the reference's size against tests/data/
    torch_port_contact_reference.json."""
    from goldfish_tpu_torch import _cuda

    s = press_problem(32, dev)
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] press num_el=32: P={P} C={C} N={P * C * 3} stack "
        f"{tuple(s.stack.R00.shape)}")
    reset_counts()
    out = press_path(s)
    counts = dict(_cuda.launch_counts)
    say_shapes("press")
    fac = out["fac"]
    say(f"[press32] continuation (cold, 4 levels) {out['t_cont']:.3f} s, "
        f"Newton its and |r| per level {out['levels']}; n_factor "
        f"{fac.n_factor} (failed {fac.n_factor_failed}, chol_factor info "
        f"{fac.failed_info}); refactor_log {fac.refactor_log}")
    say(f"[press32] |r|/|r(0)| {out['rn'] / out['r0']:.3e} (gate 1e-8), W_c "
        f"{out['W_c']!r}, midspan u_z {out['mid']!r} (gate < -0.02); J = W_int "
        f"{out['J']!r}, value and adjoint gradient {out['t_adj']:.3f} s; FD "
        f"rel {out['fd_rel']:.3e} (gate 1e-5)")
    if not (out["rn"] / out["r0"] < 1e-8 and out["W_c"] > 0.0
            and out["mid"] < -0.02 and out["fd_rel"] < 1e-5
            and bool(torch.isfinite(out["g"]).all())):
        raise RuntimeError("press32 misses tests/test_contact.py's criteria")
    check_counts("press", counts, PRESS_KERNELS + CHOL)
    library = time_library("press32", fac)
    for name, case in check_contact(s, out["d"],
                                    "contact-kernel press32").items():
        merge(checks, name, case)
        merge(checks, name, got16[name], "press16")
    path_kernels(s, out["d"], checks, "press-kernel", "press", 24)
    counts_fwd = phase_contact_fwd(s, out["d"], checks)
    dense = {k: out[k] for k in ("d", "J", "g")}
    del s, out, fac
    torch.cuda.empty_cache()

    n = ref["num_el"]
    out = press_path(press_problem(n, dev))
    tag = f"press{n}"
    say(f"[{tag}] continuation {out['t_cont']:.3f} s, levels "
        f"{out['levels']}; J {out['J']!r} (ref {ref['J']!r}); FD rel "
        f"{out['fd_rel']:.3e}")
    check_rel(tag, "d", out["d"].cpu(), ref["d"], 1e-8)
    check_rel(tag, "W_c", out["W_c"], ref["W_c"], 1e-8)
    check_rel(tag, "dJ/dh", out["g"], ref["dJ_dh"], 1e-6)
    return counts, library, counts_fwd, dense


def phase_contact_fwd(s, d, checks, seed=31):
    """31: the contact force's forward design tangent at the press32
    equilibrium d. K12 mode 3 against its plain version with dx = 0 and a
    seeded dw (the weights' term alone; the seeded-tcp case runs in
    `contact_cases`), then the counted path: `DispImOperation.
    apply_linear_fwd(d_cp=...)` at d by a dot test against
    `apply_linear_rev` (1e-10), which must launch K12 mode 3. Returns the
    path's counts."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.operations import DispImOperation
    from goldfish_tpu_torch.physics import contact as pc

    t_phase = time.perf_counter()
    c = s.data.contact
    Q = s.stack.R00.shape[2]
    x, w = (t.contiguous() for t in pc.contact_qps(s.stack, d, s.cp))
    rng = np.random.default_rng(seed)
    dx = torch.zeros_like(x)
    dw = torch.tensor(rng.normal(size=tuple(w.shape)), device=w.device) \
        * (w != 0)
    cells = pc.contact_cells(c, x, w, Q)
    n_pairs = sum(int(((dphi != 0) & (ww != 0)).sum())
                  for *_, dphi, _, ww in pc._pairs(c, x, w))
    got = check_kernels({"contact_pairs/design_fwd": (
        lambda: pc.contact_force_jvp(c, x, w, dx, dw, cells=cells),
        lambda: pc._design_jvp_plain(c, x, w, dx, dw),
        n_pairs * CONTACT_OPS["contact_pairs/design_fwd"],
        [x, w, c.pa, c.pb, c.k_pen, c.r_max, dx, dw])},
        "contact-fwd press32 dx=0", reps=3, tol=CONTACT_TOL)
    merge(checks, "contact_pairs/design_fwd",
          got["contact_pairs/design_fwd"], "dw_only")

    op = DispImOperation(s)
    lay = op.layout
    flat = lambda t: lay.to_flat(t).reshape(-1).cpu().numpy()  # noqa
    op.linearize(flat(s.cp), flat(s.h_init), flat(d))
    t_cp = rng.normal(size=op.vec_size)
    r_bar = rng.normal(size=op.vec_size)
    reset_counts()
    dt = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = op.apply_linear_fwd(d_cp=t_cp)
        dt.append(time.perf_counter() - t0)
        if len(dt) == 1:
            counts = dict(_cuda.launch_counts)
    cp_b, _, _ = op.apply_linear_rev(r_bar)
    lhs, rhs = float(r_bar @ y), float(cp_b @ t_cp)
    e = abs(lhs - rhs) / abs(rhs)
    say(f"[contact-fwd] apply_linear_fwd(d_cp) {dt[0]:.3f} s, again "
        f"{dt[1]:.3f} s (the first call's counts); dot test "
        f"r.(dR/dcp t) {lhs!r} vs (dR/dcp^T r).t {rhs!r}: rel {e:.3e} "
        f"(gate 1e-10); phase 31 {time.perf_counter() - t_phase:.1f} s")
    if not e <= 1e-10:
        raise RuntimeError(f"contact-fwd: dot test rel {e:.3e} > 1e-10")
    check_counts("contact-fwd", counts, ("contact_pairs/design_fwd",))
    return counts


# ------------------------------------------------------------ contact routes
# The T-beam driven into a stop plate (tests/_torch_port_common.py keeps the
# same builder for the CPU tests): bench_mi's moving-seam T-beam with its
# tip load replaced by an upward areal field load q on the flange, a flat
# plate at z = gap over x in [-1.2, 1.2], y in [14, 20] (the outer 30% of
# the span), clamped on its four sides and meshed no coarser than the
# flange, contact (flange, stop). At full width r_max (0.25) is above both
# patches' qp spacing (0.17 along the span) and the gap above r_max.
TBEAM_STOP_CARD = dict(num_el=40, p=3, n_pts=17, q=40.0, gap=0.3,
                       r_max=0.25, k_pen=1e7)
TBEAM_STOP_SMALL = dict(num_el=4, p=2, n_pts=5, q=80.0, gap=1.6,
                        r_max=1.5, k_pen=1e7)
STOP_X, STOP_Y = 1.2, (14.0, 20.0)
TBEAM_STOP_AMP = 0.05


def tbeam_stop_problem(dev, num_el, p, n_pts, q, gap, r_max, k_pen):
    """The T-beam and stop plate (see TBEAM_STOP_CARD) on `dev`."""
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

    nx, ny = -(-12 * max(num_el // 2, 1) // 10), -(-3 * num_el // 10)
    (y0, y1), x = STOP_Y, STOP_X
    stop = tbeam.create_surf([[-x, y0, gap], [x, y0, gap], [-x, y1, gap],
                              [x, y1, gap]], nx, ny, p)
    s = MINonMatchingSystem(tbeam._surfs(num_el, p) + [stop], tbeam.E,
                            tbeam.NU, tbeam.H_TH,
                            specs=[tbeam._seam(n_pts - 1)],
                            n_pts_list=[n_pts], device=dev)
    s.add_side_bc(0, direction=1, side=0, n_layers=1)
    s.add_side_bc(1, direction=1, side=0, n_layers=1)
    for direction in (0, 1):
        for side in (0, 1):
            s.add_side_bc(2, direction=direction, side=side, n_layers=1)
    f = np.zeros(tuple(s.cp.shape))
    f[0, : s.metas[0].n_cp, 2] = q
    s.set_areal_field(f)
    s.set_contact([(0, 2)], k_pen=k_pen, r_max=r_max)
    return s


def tbeam_stop_path(s, fd=True, seed=33, adjoint_tol=None):
    """Four warm load levels at cp(amp) on one persistent MI factor, then J
    = W_int with dJ/d(amp) and dJ/dh through `build_forward` at full load
    from the third level's d (its adjoint's certificate gate `adjoint_tol`
    where given, else the factor's default), and (`fd`) their central
    differences (amp step 1e-4, h along a seeded v at 1e-6)."""
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.physics.contact import contact_energy
    from goldfish_tpu_torch.solver.system import scale_loads
    from goldfish_tpu_torch.solver.system_mi import (
        PersistentDeviceFactorMI,
        newton_solve_mi_host,
        residual_mi,
    )

    dev = s.cp.device
    m = s.metas[1]
    bend = mi_bend(s, dev)

    def cp_of(a):
        cp = s.cp.clone()
        cp[1, : m.n_cp, 0] = cp[1, : m.n_cp, 0] + a * bend
        return cp

    args = s.mi_args
    h = s.h_init
    cp = cp_of(TBEAM_STOP_AMP)
    zero = s.zero_displacement()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xi = s.c2x.solve(cp).detach()
    fac = PersistentDeviceFactorMI(*args)
    d, levels, ds = zero, [], []
    for k in range(1, 5):
        data = scale_loads(s.data, k / 4)
        r0 = float(torch.linalg.norm(residual_mi(data, *args[1:], zero, cp,
                                                 h, xi)))
        d, its, rn = newton_solve_mi_host(data, *args[1:], cp, h, xi, d,
                                          rtol=1e-10, atol=0.0, max_it=40,
                                          device_fac=fac)
        Wc = 0.0 if s.data.contact is None else float(contact_energy(
            s.data.contact, s.stack, d, cp))
        levels.append(dict(its=int(its), r=float(rn), r0=r0, Wc=Wc))
        ds.append(d)
    torch.cuda.synchronize()
    t_levels = time.perf_counter() - t0
    forward = s.build_forward(rtol=1e-10, max_it=40)
    solver = forward.solve_d.solver
    if adjoint_tol is not None:
        solver.factor._ADJOINT_TOL = adjoint_tol
    t0 = time.perf_counter()
    a = torch.tensor(TBEAM_STOP_AMP, dtype=torch.float64, device=dev,
                     requires_grad=True)
    hh = h.clone().requires_grad_(True)
    cpa = cp_of(a)
    dd, xx = forward(cpa, hh, ds[-2])
    J = kl_shell.internal_energy(s.stack, dd, cpa, hh, s.E, s.nu)
    J.backward()
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    out = dict(levels=levels, ds=ds, d=dd.detach(), xi=xx.detach(), cp=cp,
               J=float(J.detach()), g_amp=float(a.grad), g_h=hh.grad.detach(),
               t_levels=t_levels, t_grad=t_grad, fac=fac, solver=solver,
               its_grad=solver.last_its,
               Wc=0.0 if s.data.contact is None else float(contact_energy(
                   s.data.contact, s.stack, dd.detach(), cp)),
               tip=float(s.evaluate_displacement(dd.detach(), 0,
                                                 [1.0, 1.0])[2]))
    if fd:
        def J_at(a_, h_):
            c = cp_of(a_)
            with torch.no_grad():
                d_, _ = forward(c, h_, out["d"])
            return float(kl_shell.internal_energy(s.stack, d_, c, h_, s.E,
                                                  s.nu))

        e = 1e-4
        fd_amp = (J_at(TBEAM_STOP_AMP + e, h)
                  - J_at(TBEAM_STOP_AMP - e, h)) / (2 * e)
        v = torch.tensor(np.random.default_rng(seed).normal(
            size=tuple(h.shape)), device=dev) * s.stack.cp_mask
        fd_h = (J_at(TBEAM_STOP_AMP, h + 1e-6 * v)
                - J_at(TBEAM_STOP_AMP, h - 1e-6 * v)) / 2e-6
        ad_h = float((out["g_h"] * v).sum())
        out.update(fd_amp_rel=abs(out["g_amp"] - fd_amp) / abs(fd_amp),
                   fd_h_rel=abs(ad_h - fd_h) / abs(fd_h))
    return out


def disp_mint_dot(s, out, seed=34, tan=None, w=None):
    """`DispMintImOperation` linearized at the path's equilibrium: the
    forward product of seeded (d_cp, d_h, d_xi, d_d) (or `tan`) against
    the reverse one of a seeded w: (fwd, rev, rel gap, counts of the first
    forward call, wall)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.operations import DispMintImOperation

    op = DispMintImOperation(s)
    lay = op.layout
    flat = lambda a: lay.to_flat(a).reshape(-1).cpu().numpy()  # noqa
    xi_f = out["xi"].reshape(-1).cpu().numpy()
    op.linearize(flat(out["cp"]), flat(s.h_init[..., None]), xi_f,
                 flat(out["d"]))
    rng = np.random.default_rng(seed)
    if tan is None:
        tan = {"d_cp": rng.normal(size=op.vec_size),
               "d_h": 1e-2 * rng.normal(size=op.h_size),
               "d_xi": 1e-3 * rng.normal(size=xi_f.shape),
               "d_d": rng.normal(size=op.vec_size)}
        w = rng.normal(size=op.vec_size)
    before = dict(_cuda.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd = op.apply_linear_fwd(**tan)
    dt = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in _cuda.launch_counts.items()}
    rev = op.apply_linear_rev(w)
    lhs = float(fwd @ w)
    rhs = float(sum(a @ b for a, b in zip(
        (tan["d_cp"], tan["d_h"], tan["d_xi"], tan["d_d"]), rev)))
    return fwd, rev, abs(lhs - rhs) / abs(lhs), counts, dt


def say_stop_path(tag, out):
    fac = out["fac"]
    lv = "; ".join(f"{k + 1}: {v['its']} its |r|/|r0| "
                   f"{v['r'] / v['r0']:.2e} W_c {v['Wc']:.6g}"
                   for k, v in enumerate(out["levels"]))
    say(f"[{tag}] levels {out['t_levels']:.3f} s ({lv}); n_factor "
        f"{fac.n_factor} (failed {fac.n_factor_failed}) refactor_log "
        f"{fac.refactor_log}; J {out['J']!r} dJ/damp {out['g_amp']!r} "
        f"(value and gradient {out['t_grad']:.3f} s, Newton its "
        f"{out['its_grad']}, its factor's certificates "
        f"{out['solver'].factor.cert_log[-3:]}); W_c {out['Wc']!r}, tip u_z "
        f"{out['tip']!r}")


def dec(e):
    """A float64 array stored as {"shape", "b64"} (little-endian bytes) by
    the reference scripts."""
    import base64

    return np.frombuffer(base64.b64decode(e["b64"]), "<f8").reshape(
        e["shape"]).copy()


def phase_tbeam_stop(dev, checks, ref):
    """33: the T-beam driven into the stop plate at full width (see the
    module docstring). Returns the counted path's launches."""
    from goldfish_tpu_torch import _cuda

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    s = tbeam_stop_problem(dev, **TBEAM_STOP_CARD)
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] tbeam_stop built in {time.perf_counter() - t0:.1f} s: "
        f"P={P} C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} seam "
        f"(I, N)=({s.mi.n_int}, {s.mi.n_max}); q {TBEAM_STOP_CARD['q']}, "
        f"gap {TBEAM_STOP_CARD['gap']}, r_max {TBEAM_STOP_CARD['r_max']}")
    phase_mi_kernels(s, checks, reps=3, system="tbeam_stop")
    reset_counts()
    out = tbeam_stop_path(s)
    fwd, rev, gap, c_fwd, t_fwd = disp_mint_dot(s, out)
    counts = dict(_cuda.launch_counts)
    say_shapes("tbeam_stop")
    say_stop_path("tbeam_stop", out)
    k12 = {k: counts[k] for k in counts if k.startswith("contact_pairs/")}
    say(f"[tbeam_stop] FD rel dJ/damp {out['fd_amp_rel']:.3e}, dJ/dh "
        f"{out['fd_h_rel']:.3e} (gate 1e-5); operation dot test rel "
        f"{gap:.3e} (gate 1e-10), apply_linear_fwd {t_fwd:.3f} s with "
        f"launches {({k: v for k, v in c_fwd.items() if v})}; K12 launches "
        f"by mode {k12}")
    lv = out["levels"]
    if not (all(v["r"] <= 1e-8 * v["r0"] for v in lv) and lv[-1]["Wc"] > 0
            and out["Wc"] > 0 and out["fd_amp_rel"] <= 1e-5
            and out["fd_h_rel"] <= 1e-5 and gap <= 1e-10
            and bool(torch.isfinite(out["g_h"]).all())):
        raise RuntimeError("tbeam_stop misses its criteria")
    check_counts("tbeam_stop", counts, TBEAM_STOP_KERNELS)
    say_route("tbeam_stop", s.c2x, counts)
    for name, case in check_contact(s, out["d"],
                                    "contact-kernel tbeam_stop").items():
        merge(checks, name, case, "tbeam_stop")
    del out
    torch.cuda.empty_cache()

    # the same model without contact against the JAX full-width numbers
    t0 = time.perf_counter()
    s.contact, s._data = None, None   # the data rebuilt without the pair
    out = tbeam_stop_path(s, fd=False)
    say_stop_path("tbeam_stop field", out)
    stop_gap = TBEAM_STOP_CARD["gap"]
    say(f"[tbeam_stop field] contact-free tip rise {out['tip']!r} (gate >= "
        f"2 x the gap, {2 * stop_gap})")
    if not out["tip"] >= 2 * stop_gap:
        raise RuntimeError("tbeam_stop: the load does not drive the flange "
                           "past twice the gap without contact")
    want = ref["field_card"]
    check_rel("tbeam_stop field", "J", out["J"], want["J"], 1e-8)
    check_rel("tbeam_stop field", "dJ/damp", out["g_amp"], want["dJ_damp"],
              1e-6)
    check_rel("tbeam_stop field", "dJ/dh", out["g_h"].cpu(),
              dec(want["dJ_dh"]), 1e-6)
    check_rel("tbeam_stop field", "d", out["d"].cpu(), dec(want["d"]), 1e-8)
    say(f"[tbeam_stop field] {time.perf_counter() - t0:.1f} s")
    del s, out
    torch.cuda.empty_cache()

    # the tests' small size with contact against the JAX numbers. The JAX
    # gradient is a direct solve; at the adjoint's default gate (1e-6, the
    # reference's) this stiff small model's gradient reads 2e-7 to 6e-7
    # from it on the card, run to run (ROADMAP C21), so the comparison
    # takes the operations' gate
    from goldfish_tpu_torch.operations.disp_imop import LINEAR_TOL

    t0 = time.perf_counter()
    want = ref["mi_small"]
    s = tbeam_stop_problem(dev, **TBEAM_STOP_SMALL)
    out = tbeam_stop_path(s, fd=False)
    e_amp = abs(out["g_amp"] - want["dJ_damp"]) / abs(want["dJ_damp"])
    e_h = rel_err(out["g_h"].cpu(), torch.as_tensor(dec(want["dJ_dh"])))[0]
    say(f"[tbeam_stop small] at the default adjoint gate: dJ/damp rel "
        f"{e_amp:.3e}, dJ/dh rel {e_h:.3e} (not gated, C21)")
    out = tbeam_stop_path(s, fd=False, adjoint_tol=LINEAR_TOL)
    say_stop_path("tbeam_stop small", out)
    tag = "tbeam_stop small"
    check_rel(tag, "J", out["J"], want["J"], 1e-8)
    check_rel(tag, "dJ/damp", out["g_amp"], want["dJ_damp"], 1e-6)
    check_rel(tag, "dJ/dh", out["g_h"].cpu(), dec(want["dJ_dh"]), 1e-6)
    check_rel(tag, "d", out["d"].cpu(), dec(want["d"]), 1e-8)
    check_rel(tag, "W_c", out["Wc"], want["Wc"], 1e-6)
    for k, dk in enumerate(dec(want["d_levels"])):
        check_rel(tag, f"d level {k + 1}", out["ds"][k].cpu(), dk, 1e-8)
    o = want["op"]
    tan = {k: dec(v) for k, v in o["tan"].items()}
    fwd, rev, gap, _, _ = disp_mint_dot(s, out, tan=tan, w=dec(o["w"]))
    check_rel(tag, "apply_linear_fwd", fwd, dec(o["fwd"]), 1e-10)
    for name, a, b in zip(("cp", "h", "xi", "d"), rev, o["rev"]):
        check_rel(tag, f"apply_linear_rev {name}", a, dec(b), 1e-10)
    if not gap <= 1e-10:
        raise RuntimeError(f"{tag}: dot test rel {gap:.3e} > 1e-10")
    say(f"[{tag}] {time.perf_counter() - t0:.1f} s; phase 33 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def patch_block_case(s, d):
    """K10 stage 1 at the press's shapes (`patch_block_precond`'s blocks:
    each plate's element Hessians, no interface, no contact) against its
    plain version."""
    from goldfish_tpu_torch.solver import krylov, system

    bt = krylov._block_tables(s.data)
    tables = system.jet_tables(s.data)
    Hs = system.jet_hessians(s.data, d, s.cp, s.h_init)
    _, Q, _, L = tables.R_e.shape
    P, n = bt.free.shape

    def plain():
        Kp = torch.empty(P, n, n, dtype=torch.float64, device=d.device)
        krylov._patch_assemble_plain(Kp, bt, tables, Hs)
        return Kp

    ge = torch.nonzero(s.stack.wq.reshape(-1, Q).sum(-1) > 0)[:, 0]
    be = bt.patch
    ins = [Hs[0][ge], tables.R_e[ge], bt.free, be.kind, be.group, be.nq,
           be.cps, be.band_ptr, be.band_ent]
    return {"pair_assemble/patches": (
        lambda: krylov.assemble_blocks(bt, tables, Hs), plain,
        k10_ops(be, L, 0), ins, PEAK_F64_TC)}


def krylov_continuation(s):
    """Four load levels by `newton_krylov_solve` (rtol 1e-9, GMRES 1e-8),
    each warm from the last: (the levels' d, [(its, |r|, |r(0)|, GMRES
    cycles a Newton step)], wall)."""
    from goldfish_tpu_torch.solver.krylov import newton_krylov_solve
    from goldfish_tpu_torch.solver.system import residual, scale_loads

    d = s.zero_displacement()
    levels, ds = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, 5):
        data = scale_loads(s.data, k / 4)
        r0 = float(torch.linalg.norm(residual(data, torch.zeros_like(d),
                                              s.cp, s.h_init)))
        log = []
        d, its, rn = newton_krylov_solve(data, s.cp, s.h_init, d, rtol=1e-9,
                                         cg_rtol=1e-8, log=log)
        levels.append((int(its), float(rn), r0,
                       [e[3] for e in log if len(e) == 4]))
        ds.append(d)
    torch.cuda.synchronize()
    return ds, levels, time.perf_counter() - t0


def krylov_gradients(s, d):
    """J = W_int and dJ/dh through `build_solve_fn_krylov` at full load
    from d (the third level's), for each preconditioner: {name: dict};
    pair-Schwarz must refuse the press (no interface pairs) as the
    reference's does."""
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.krylov import build_solve_fn_krylov

    out = {}
    for pre in ("full", "patch", "pair_schwarz"):
        try:
            solve = build_solve_fn_krylov(s.data, rtol=1e-10, cg_rtol=1e-10,
                                          precond=pre)
        except AssertionError as e:
            if pre != "pair_schwarz" or s.data.ifs is not None:
                raise
            out[pre] = dict(refused=str(e))
            continue
        h = s.h_init.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dd = solve(s.cp, h, d)
        J = kl_shell.internal_energy(s.stack, dd, s.cp, h, s.E, s.nu)
        J.backward()
        torch.cuda.synchronize()
        sv = solve.solver
        out[pre] = dict(d=dd.detach(), J=float(J.detach()),
                        g=h.grad.detach(), wall=time.perf_counter() - t0,
                        its=sv.last_its, cycles=[e[3] for e in sv.last_log
                                                 if len(e) == 4],
                        adjoint_cycles=sv.adjoint_cycles[-1])
    return out


def say_krylov(tag, levels, t_cont, grads):
    say(f"[{tag}] Newton-Krylov continuation {t_cont:.3f} s: " + "; ".join(
        f"level {k + 1}: {its} its |r|/|r0| {rn / r0:.2e} GMRES cycles a "
        f"step {cyc}" for k, (its, rn, r0, cyc) in enumerate(levels)))
    for pre, g in grads.items():
        if "refused" in g:
            say(f"[{tag}] {pre}: refused ({g['refused']}), as the "
                f"reference's")
            continue
        say(f"[{tag}] {pre}: value and adjoint gradient {g['wall']:.3f} s, "
            f"Newton its {g['its']}, GMRES cycles a step {g['cycles']}, "
            f"adjoint GMRES cycles {g['adjoint_cycles']}; J {g['J']!r}")


def phase_press32_krylov(dev, checks, dense, ref6):
    """34: the press at num_el=32 on the Newton-Krylov route (see the
    module docstring) against the dense route's `dense` (phase 21) and, at
    num_el=6, the JAX dense numbers `ref6`. Returns the counted path's
    launches."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics.contact import contact_energy

    t_phase = time.perf_counter()
    s = press_problem(32, dev)
    reset_counts()
    ds, levels, t_cont = krylov_continuation(s)
    d = ds[-1]
    grads = krylov_gradients(s, ds[-2])
    counts = dict(_cuda.launch_counts)
    say_shapes("press32_krylov")
    say_krylov("press32_krylov", levels, t_cont, grads)
    k12 = {k: counts[k] for k in counts if k.startswith("contact_pairs/")}
    n_lu = sum(its for its, *_ in levels) + sum(
        g["its"] + 1 for g in grads.values() if "refused" not in g)
    say(f"[press32_krylov] K12 launches by mode {k12}; no persistent factor: "
        f"{n_lu} preconditioner factorizations (dense LU or patch blocks, "
        f"one a Newton step and one an adjoint)")
    Wc = float(contact_energy(s.data.contact, s.stack, d, s.cp))
    if not (all(rn <= 1e-9 * r0 for _, rn, r0, _ in levels) and Wc > 0):
        raise RuntimeError(f"press32_krylov: levels {levels}, W_c {Wc!r}")
    check_counts("press32_krylov", counts, PRESS_KRYLOV_KERNELS)
    check_rel("press32_krylov", "continuation d", d.cpu(), dense["d"].cpu(),
              1e-8)
    for pre, g in grads.items():
        if "refused" in g:
            continue
        tag = f"press32_krylov {pre}"
        check_rel(tag, "d", g["d"].cpu(), dense["d"].cpu(), 1e-8)
        check_rel(tag, "J", g["J"], dense["J"], 1e-8)
        check_rel(tag, "dJ/dh", g["g"].cpu(), dense["g"].cpu(), 1e-6)
    for name, got in check_kernels(patch_block_case(s, d),
                                   "krylov-kernel press32").items():
        merge(checks, name, got, "press32")
    del s, grads, ds
    torch.cuda.empty_cache()

    n = ref6["num_el"]
    s = press_problem(n, dev)
    ds, levels, t_cont = krylov_continuation(s)
    d = ds[-1]
    grads = krylov_gradients(s, ds[-2])
    tag = f"press{n}_krylov"
    say_krylov(tag, levels, t_cont, grads)
    check_rel(tag, "continuation d", d.cpu(), ref6["d"], 1e-8)
    for pre, g in grads.items():
        if "refused" in g:
            continue
        check_rel(f"{tag} {pre}", "d", g["d"].cpu(), ref6["d"], 1e-8)
        check_rel(f"{tag} {pre}", "dJ/dh", g["g"].cpu(), ref6["dJ_dh"], 1e-6)
    say(f"[press32_krylov] phase 34 {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_riks(dev, ref, checks):
    """Riks through the panel's snap-through at num_el=24 against the JAX
    test's criteria and the reference; then K1-K4 at its shapes."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver.riks import riks_solve
    from goldfish_tpu_torch.solver.system import residual, scale_loads

    s = riks_panel(ref["num_el"], dev)
    P, C = s.stack.n_patches, s.stack.max_cp
    N = P * C * 3
    d0 = s.zero_displacement()
    stats = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, lam, path = riks_solve(s.data, s.cp, s.h_init, d0, lam_target=1.0,
                              dlam0=0.02, rtol=1e-6, dl_max=60.0,
                              max_steps=150, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    say_shapes("riks")
    lams = np.array([p[0] for p in path])
    norms = np.array([p[1] for p in path])
    i_peak = int(np.argmax(lams[: len(lams) // 2]))
    peak, valley = lams[i_peak], lams[i_peak:].min()
    pre = norms[: i_peak + 1].max()
    data1 = scale_loads(s.data, 1.0)
    rn = float(torch.linalg.norm(residual(data1, d, s.cp, s.h_init)))
    q0 = float(torch.linalg.norm(residual(data1, d0, s.cp, s.h_init)))
    say(f"[riks{ref['num_el']}] N={N}: {dt:.3f} s, {stats['steps']} steps, "
        f"{len(path)} path points (ref {ref['n_points']}), {stats['n_lu']} "
        f"LUs, corrector its {stats['its']}, polish its "
        f"{stats.get('polish_its')}; lam {lam!r}, |r|/|q| {rn / q0:.3e} "
        f"(gate 1e-5), lam_peak {peak!r} (ref {ref['lam_peak']!r}), "
        f"lam_valley {valley!r}, |d| end {norms[-1]!r} vs pre-limit {pre!r}")
    if not (lam == 1.0 and rn < 1e-5 * q0 and peak > valley + 0.2
            and norms[-1] > 3.0 * pre and bool(torch.isfinite(d).all())):
        raise RuntimeError("riks misses tests/test_riks.py's criteria")
    check_rel(f"riks{ref['num_el']}", "final d", d.cpu(), ref["d"], 1e-6)
    if not abs(peak - ref["lam_peak"]) <= 1e-3:
        raise RuntimeError(f"riks lam_peak {peak!r} vs {ref['lam_peak']!r}")
    check_counts("riks", counts, RIKS_KERNELS)
    path_kernels(s, d, checks, "riks-kernel", "riks", 25)
    from goldfish_tpu_torch.solver.system import assemble_K

    K = assemble_K(data1, d, s.cp, s.h_init)
    row = dict(name="lu_factor_ex", path=f"riks{ref['num_el']}", n=N,
               info=int(torch.linalg.lu_factor_ex(K)[2]),
               ms=cuda_ms(lambda: torch.linalg.lu_factor_ex(K), 5),
               bound_ms=2 * N ** 3 / 3 / PEAK_F64_TC * 1e3,
               bound_by="operations")
    say(f"[library] {json.dumps(row)}")
    return counts, [row]


def walls(prob):
    """Median host walls (s) of a problem's fun and jac evaluations and
    their numbers."""
    f, j = prob.eval_wall["fun"], prob.eval_wall["jac"]
    med = lambda v: float(np.median(v)) if v else float("nan")  # noqa
    return (f"fun {med(f):.3f} s x{len(f)}, jac {med(j):.3f} s "
            f"x{len(j)} (median walls)")


def wing_constraints(ns, x):
    """(volume's relative gap to V0, max |A h_ffd|) at design x."""
    with torch.no_grad():
        h = torch.tensor(np.asarray(x, dtype=np.float64),
                         device=ns.sys.device)
        V = float(ns.vol({"h_ffd": h}))
    return abs(V - ns.V0) / abs(ns.V0), float(np.abs(ns.A @ np.asarray(
        x, dtype=np.float64)).max())


class _Killed(RuntimeError):
    pass


def phase_wing_driver(dev, ref20, ref):
    """29: the flagship wing driver (`demos/wing_thickness_opt`) at full
    width (num_el=6, p=3, N = 6600). Its start J and dJ/dh_ffd against the
    wing20 reference (the same objective at the same design; the SLSQP
    surface's gradient is dJ/dh_ffd over the design scaler 1e2); the
    counted, uninterrupted `main(maxiter=3)` against the JAX run (design
    1e-6; J at the JAX end design 1e-8, the run's end J 1e-7); then one
    process's process-death check: a run of
    maxiter=6 killed by its iteration callback after 3 accepted iterations,
    a fresh problem resumed from the checkpoint (done == 3, its design, its
    first J equal to the checkpoint's to 1e-12), at the end J lower than at
    the start, volume within 1e-8, align rows <= 1e-10; and the pyOptSparse
    route (SNOPT on the port's shim, maxiter 3) from the same start.
    Returns the uninterrupted run's counts."""
    import tempfile

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import wing_thickness_opt as demo
    from goldfish_tpu_torch.utils.checkpoint import Checkpointer, resume_run
    from goldfish_tpu_torch.utils.profiling import profiler

    t_phase = time.perf_counter()
    tag = "wing-driver"
    ns = demo.setup(6, 3, device=dev)
    wing20 = ns.sys
    g20 = (np.asarray(ref20["dJ_dh_ffd"]) / 1e2).tolist()
    J0 = check_start(tag, ns.prob, dict(J=ref20["J"], grad=g20))
    check_start(tag + " vs drivers run", ns.prob,
                dict(J=ref["J_start"], grad=ref["g_start"]))
    del ns
    torch.cuda.empty_cache()

    ns = demo.setup(system=wing20)
    profiler.reset()
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        res, _, _ = demo.main(maxiter=3, results=out, verbose=False, ns=ns)
        files = sorted(os.listdir(out))
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    fac = ns.solve.device_factor
    vtk = [f for f in files if f.endswith(".vtk")]
    say(f"[{tag}] main(maxiter=3) {wall:.2f} s: nit {res.nit} nfev "
        f"{res.nfev} njev {res.njev} (JAX run {ref['nit']}/{ref['nfev']}/"
        f"{ref['njev']}); {walls(ns.prob)}; factorizations {fac.n_factor} "
        f"(failed {fac.n_factor_failed}); wrote opt_state.npz "
        f"{'opt_state.npz' in files} and {len(vtk)} .vtk")
    say(profiler.summary())
    check_rel(tag, "end design", res.x["h_ffd"], ref["x_end"], 1e-6)
    # J itself at the JAX run's end design (cold); the run's own end J
    # moves with its design (a 1e-7 design gap moves J ~2e-8 at num_el=2)
    with torch.no_grad():
        J_at = float(ns.obj({"h_ffd": torch.tensor(
            ref["x_end"], dtype=torch.float64, device=dev)},
                            ns.sys.zero_displacement())[0])
    check_rel(tag, "J at the JAX end design", J_at, ref["fun_end"], 1e-8)
    check_rel(tag, "end J", res.fun, ref["fun_end"], 1e-7)
    if not ("opt_state.npz" in files and len(vtk) == 20):
        raise RuntimeError(f"{tag}: outputs missing: {files}")
    check_counts(tag, counts, WING_KERNELS)
    x_slsqp = np.asarray(res.x["h_ffd"])
    del ns
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "opt_state.npz")
        ns1 = demo.setup(system=wing20)
        n_cb = [0]

        def killer(xdict, J):
            n_cb[0] += 1
            if n_cb[0] >= 3:
                raise _Killed("killed after 3 accepted iterations")

        ns1.prob.iter_callback = killer
        try:
            resume_run(ns1.prob, Checkpointer(path), maxiter=6, tol=1e-12)
            raise RuntimeError(f"{tag}: the run was not killed")
        except _Killed:
            pass
        design, _, meta = Checkpointer(path).load()
        del ns1
        ns2 = demo.setup(system=wing20)
        first = []
        obj = ns2.prob._obj

        def recorded(dvs, d0):
            J, d = obj(dvs, d0)
            if not first:
                first.append(float(J.detach()))
            return J, d

        ns2.prob._obj = recorded
        t0 = time.perf_counter()
        res2, done = resume_run(ns2.prob, Checkpointer(path), maxiter=6,
                                tol=1e-12)
        wall2 = time.perf_counter() - t0
    e_first = abs(first[0] - meta["J"]) / abs(meta["J"])
    e_vol, e_align = wing_constraints(ns2, res2.x["h_ffd"])
    same = np.array_equal(ns2.prob._dvs[0].init.ravel(),
                          np.asarray(design["h_ffd"]).ravel())
    say(f"[{tag}] killed at iter {meta['iter']} (J {meta['J']!r}); resumed "
        f"with done {done} from its design {same}: first J {first[0]!r} "
        f"(rel {e_first:.3e}, gate 1e-12), {res2.nit} more its in "
        f"{wall2:.2f} s, J {J0!r} -> {res2.fun!r}; volume rel {e_vol:.3e} "
        f"(gate 1e-8), align max {e_align:.3e} (gate 1e-10)")
    if not (done == 3 == meta["iter"] and same and e_first <= 1e-12
            and res2.fun < J0 and e_vol <= 1e-8 and e_align <= 1e-10):
        raise RuntimeError(f"{tag}: the kill-and-resume check failed")
    del ns2
    torch.cuda.empty_cache()

    ns3 = demo.setup(system=wing20)
    t0 = time.perf_counter()
    res3 = ns3.prob.run(optimizer="SNOPT", maxiter=3, tol=1e-12)
    wall3 = time.perf_counter() - t0
    e_vol, e_align = wing_constraints(ns3, res3.x["h_ffd"])
    dist = float(np.linalg.norm(np.asarray(res3.x["h_ffd"]) - x_slsqp)
                 / np.linalg.norm(x_slsqp))
    say(f"[{tag}] pyOptSparse route (SNOPT on the port's shim, maxiter 3) "
        f"{wall3:.2f} s: J {J0!r} -> {res3.fun!r} ({res3.message}); "
        f"{walls(ns3.prob)}; volume rel {e_vol:.3e}, align max "
        f"{e_align:.3e}; distance to the SLSQP route's design {dist:.3e}")
    if not (res3.fun < J0 and e_vol <= 1e-6 and e_align <= 1e-10):
        raise RuntimeError(f"{tag}: the pyOptSparse route missed its "
                           f"criteria")
    del ns3
    torch.cuda.empty_cache()
    say(f"[{tag}] phase 29 {time.perf_counter() - t_phase:.1f} s")
    return counts


# PR 18's forward modes, which the CSDL graph's forward totals run
FWD_MI_KERNELS = ("shell_qp/design_fwd", "penalty_qp/design_fwd",
                  "mi_penalty_xi/xi_fwd", "c2x_res_jac/cp_fwd")
# the reverse totals' products: K1/K2 mode c, K6, K4 and K7 mode 1
REV_MI_KERNELS = ("shell_qp/adjoint", "penalty_qp/adjoint", "mi_penalty_xi",
                  "jet_matvec", "c2x_res_jac/adjoint")


def csdl_mi_graph(s, amp, rtol=1e-11):
    """tests/test_csdl_adapters.py's CP -> xi -> u -> w_int CSDL graph on
    the MI T-beam s: a 1-dof amplitude bending the web's x rows by sin(pi
    v). Returns (recorder, vars)."""
    from goldfish_tpu_torch import csdl_shim as csdl
    from goldfish_tpu_torch.csdl_models.models import (
        CPIGA2XiModel,
        DispMintStatesModel,
        IntEnergyModel,
    )
    from goldfish_tpu_torch.design.pipeline import CPLayout

    lay = CPLayout(s.metas, s.stack.max_cp, s.device)
    cp0 = lay.to_flat(s.cp).reshape(-1).cpu().numpy()
    m = s.metas[1]
    bend = mi_bend(s, "cpu").numpy()
    B = np.zeros((cp0.size, 1))
    B[(lay.offsets[1] + np.arange(m.n_cp)) * 3, 0] = bend

    class CPFromAmp(csdl.CustomExplicitOperation):
        def evaluate(self, a):
            self.declare_input("amp", a)
            return self.create_output("cp", (cp0.size,))

        def compute(self, inputs, outputs):
            outputs["cp"] = cp0 + B @ inputs["amp"]

        def compute_derivatives(self, inputs, outputs, derivs):
            derivs["cp", "amp"] = B

    rec = csdl.Recorder(inline=True)
    rec.start()
    a = csdl.Variable(value=np.array([amp]), name="amp")
    cp = CPFromAmp().evaluate(a)
    xi = CPIGA2XiModel(s).evaluate(cp)
    h = csdl.Variable(value=np.full(lay.n_flat, float(s.h_init.max())),
                      name="h")
    u = DispMintStatesModel(s, rtol=rtol).evaluate(cp, h, xi)
    w_int = IntEnergyModel(s).evaluate(cp, h, u)
    w_int.add_name("w_int")
    rec.stop()
    return rec, dict(amp=a, w_int=w_int)


def timed_sim(csdl):
    """Wrap the shim simulator's run and compute_totals to log their walls
    (restored by calling the returned undo)."""
    cls = csdl.experimental.PySimulator
    run, tot = cls.run, cls.compute_totals
    walls_ = {"run": [], "totals": []}

    def t_run(self, *a, **kw):
        t0 = time.perf_counter()
        out = run(self, *a, **kw)
        walls_["run"].append(time.perf_counter() - t0)
        return out

    def t_tot(self, *a, **kw):
        t0 = time.perf_counter()
        out = tot(self, *a, **kw)
        walls_["totals"].append(time.perf_counter() - t0)
        return out

    cls.run, cls.compute_totals = t_run, t_tot

    def undo():
        cls.run, cls.compute_totals = run, tot

    return walls_, undo


def phase_csdl(dev, ref_mi, ref):
    """30: the CSDL layer on the card. The MI graph at bench_mi's full
    size (num_el=40, p=3, n_pts=17, amp 0.05): w_int against the MI
    reference's J (1e-8), the default-mode totals (forward: 1 wrt, 1 of)
    and the reverse totals against its dJ/damp (1e-6) and each other
    (1e-8), each sweep counted (PR 18's forward modes in the forward one,
    K1/K2 mode c, K6, K4 and K7 mode 1 in the reverse one); then the CSDL
    plate demo at plate32's width (num_el=32, p=2, 3 patches): its start
    w_int, vol and their totals in both modes against the JAX start (1e-8,
    1e-6), and `main(maxiter=10)` with the demo's assertions. Returns the
    counts {"csdl_fwd":, "csdl_rev":, "csdl_plate":}."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch import csdl_shim as csdl
    from goldfish_tpu_torch.demos import csdl_plate_const_th_opt as demo
    from goldfish_tpu_torch.models import tbeam

    t_phase = time.perf_counter()
    tag = "csdl-mi"
    s = tbeam.build_mi(num_el=40, p=3, n_pts=17, device=dev)
    t0 = time.perf_counter()
    rec, v = csdl_mi_graph(s, ref_mi["amp"])
    say(f"[{tag}] graph evaluated in {time.perf_counter() - t0:.2f} s "
        f"(N = {int(s.cp.numel())})")
    check_rel(tag, "w_int", float(np.asarray(v["w_int"].value).ravel()[0]),
              ref_mi["J"], 1e-8)
    sim = csdl.experimental.PySimulator(rec)
    got, counts = {}, {}
    for mode in (None, "rev"):
        key = "csdl_fwd" if mode is None else "csdl_rev"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J = sim.compute_totals([v["w_int"]], [v["amp"]], mode=mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[key] = dict(_cuda.launch_counts)
        got[key] = float(np.asarray(J[v["w_int"], v["amp"]]).ravel()[0])
        say(f"[{tag}] totals mode {mode or 'default (fwd)'} {dt:.3f} s: "
            f"dw_int/damp {got[key]!r} (ref {ref_mi['dJ_damp']!r})")
        check_rel(tag, f"{key} totals", got[key], ref_mi["dJ_damp"], 1e-6)
    check_rel(tag, "fwd vs rev", got["csdl_fwd"], got["csdl_rev"], 1e-8)
    check_counts(tag + " fwd", counts["csdl_fwd"], FWD_MI_KERNELS)
    check_counts(tag + " rev", counts["csdl_rev"], REV_MI_KERNELS)
    del rec, v, sim, s
    torch.cuda.empty_cache()

    tag = "csdl-plate"
    t0 = time.perf_counter()
    rec, v, s = demo.build_recorder(num_el=32, p=2, num_patches=3,
                                    device=dev)
    say(f"[{tag}] graph evaluated in {time.perf_counter() - t0:.2f} s "
        f"(N = {int(v['u'].value.size)})")
    for name in ("w_int", "vol"):
        check_rel(tag, name, float(np.asarray(v[name].value).ravel()[0]),
                  ref[name], 1e-8)
    sim = csdl.experimental.PySimulator(rec)
    for name in ("w_int", "vol"):
        for mode in ("fwd", "rev"):
            J = sim.compute_totals([v[name]], [v["h_th_design"]], mode=mode)
            check_rel(tag, f"d{name} {mode}", J[v[name], v["h_th_design"]],
                      ref[f"d{name}_{mode}"], 1e-6)
    rec.stop()
    del rec, v, sim, s
    torch.cuda.empty_cache()
    w, undo = timed_sim(csdl)
    reset_counts()
    t0 = time.perf_counter()
    try:
        v, _ = demo.main(num_el=32, p=2, num_patches=3, maxiter=10,
                         verbose=False, device=dev)
    finally:
        undo()
    wall = time.perf_counter() - t0
    counts["csdl_plate"] = dict(_cuda.launch_counts)
    med = lambda a: float(np.median(a)) if a else float("nan")  # noqa
    say(f"[{tag}] main(maxiter=10) {wall:.2f} s (the demo's assertions "
        f"held): w_int {ref['w_int']!r} -> "
        f"{float(np.asarray(v['w_int'].value).ravel()[0])!r}; run "
        f"{med(w['run']):.3f} s x{len(w['run'])}, totals "
        f"{med(w['totals']):.3f} s x{len(w['totals'])} (median walls)")
    check_counts(tag, counts["csdl_plate"], WING_KERNELS)
    say(f"[csdl] phase 30 {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_demos_rest(dev, ref):
    """32: the four remaining demos at their defaults on the card: each
    start against the JAX start at that size (J 1e-8, gradient 1e-6; the
    fixed-seam T-beam 1e-7, 1e-4, C16; the aeroelastic W_int at the JAX
    final state 1e-12, J0 and tip 1e-7 (the JAX first pass stops early,
    C17), dJ/dh 1e-6), then each counted `main`
    with the JAX tests' criteria (tests/test_demos.py) and its walls.
    Returns {path: counts}."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import aeroelastic_wing as aero
    from goldfish_tpu_torch.demos import shape_opt_arch as arch
    from goldfish_tpu_torch.demos import shape_opt_mint_tbeam as mint
    from goldfish_tpu_torch.demos import tbeam_shape_opt as tb

    t_phase = time.perf_counter()
    counts = {}
    for key, mod in (("demo_tbeam", tb), ("demo_arch", arch),
                     ("demo_mint", mint)):
        tag = key.replace("_", "-")
        want = ref[key[5:] + "_card"]
        # the fixed-seam T-beam's tangent (E = 1e12, nu = 0) is conditioned
        # past what an f64 solve resolves to 1e-8 / 1e-6 (ROADMAP C16)
        tols = (1e-7, 1e-4) if key == "demo_tbeam" else (1e-8, 1e-6)
        check_start(tag, mod.setup(device=dev).prob,
                    dict(J=want["J_start"], grad=want["g_start"]), *tols)
        torch.cuda.empty_cache()
        ns = mod.setup(device=dev)
        reset_counts()
        t0 = time.perf_counter()
        out = mod.main(verbose=False, ns=ns)
        wall = time.perf_counter() - t0
        counts[key] = dict(_cuda.launch_counts)
        res, J0 = out[0], out[1]
        line = (f"[{tag}] main {wall:.2f} s: nit {res.nit} nfev {res.nfev} "
                f"njev {res.njev} ({res.message}); {walls(ns.prob)}; W_int "
                f"{J0!r} -> {res.fun!r} ({res.fun / J0:.4f} J0)")
        if key == "demo_tbeam":
            wx = out[2]
            say(line + f"; web x 0.4 -> {wx:.4f}")
            ok = res.fun < J0 and abs(wx) < 0.4
        elif key == "demo_arch":
            say(line)
            ok = res.fun < 0.3 * J0
        else:
            say(line)
            ok = res.fun < 0.9 * J0
        if not ok:
            raise RuntimeError(f"{tag}: misses the JAX test's criteria")
        check_counts(tag, counts[key], WING_KERNELS if key != "demo_mint"
                     else WING_KERNELS + ("traced_rows", "mi_penalty_xi"))
        del ns
        torch.cuda.empty_cache()

    tag, want = "demo-aero", ref["aero_card"]
    reset_counts()
    t0 = time.perf_counter()
    J0, tip, gh, s = aero.main(verbose=False, device=dev)
    wall = time.perf_counter() - t0
    counts["demo_aero"] = dict(_cuda.launch_counts)
    say(f"[{tag}] main {wall:.2f} s: J0 {J0!r} (ref {want['J0']!r}), tip "
        f"u_z {float(tip[2])!r} (ref {want['tip'][2]!r}); the JAX fixed "
        f"point's passes stopped at |r|/|r(0)| "
        f"{[a / b for a, b in zip(want['r_pass'], want['r0_pass'])]}")
    # the same model: the port's energy at the JAX run's final state is the
    # JAX J0; the JAX first pass stops at |r| ~ 1e-3 |r(0)|, which moves the
    # unrolled fixed point by ~2e-8 (ROADMAP C17): J0 and tip at 1e-7
    from goldfish_tpu_torch.physics import kl_shell

    d_jax = torch.tensor(want["d"], dtype=torch.float64,
                         device=dev).reshape(s.cp.shape)
    with torch.no_grad():
        J_at = float(kl_shell.internal_energy(s.stack, d_jax, s.cp, s.h_init,
                                              s.E, s.nu))
    check_rel(tag, "W_int at the JAX state", J_at, want["J0"], 1e-12)
    check_rel(tag, "J0", J0, want["J0"], 1e-7)
    check_rel(tag, "tip", tip, want["tip"], 1e-7)
    check_rel(tag, "dJ/dh", gh.cpu(), np.asarray(want["dJ_dh"]).reshape(
        want["gh_shape"]), 1e-6)
    if not (J0 > 0 and float(tip[2]) > 0
            and bool(torch.isfinite(gh).all())):
        raise RuntimeError(f"{tag}: misses the JAX test's criteria")
    check_counts(tag, counts["demo_aero"], WING_KERNELS)
    say(f"[demos] phase 32 {time.perf_counter() - t_phase:.1f} s")
    return counts


# phase 1's cold iteration (J, dJ/dh_ffd, wall), for the sharded phase
MAIN_COLD = {}
# MULTICHIP_r05.json: the JAX package's sharded-vs-unsharded dJ on 8 CPU
# devices, the yardstick of the port's two-rank legs
JAX_MULTICHIP_DJ = {"wing": 6.31e-7, "boxwing": 4.62e-8, "mi": 5.66e-11}
K1_TO_K4 = ("shell_qp/value_grad", "shell_qp/hess", "shell_qp/adjoint",
            "penalty_qp/value_grad", "penalty_qp/hess", "penalty_qp/adjoint",
            "jet_assemble", "jet_matvec")


def offset_map_checks(sys_, th, h0, dev):
    """K3 and K4 on rank 1 of a two-rank split of the full-width wing (a
    PatchShard made by hand; the tables need no collective): the element
    dof maps are offset by lo*C*3, the one input those kernels have not
    seen before. Against their plain versions on the same inputs."""
    from goldfish_tpu_torch.parallel.sharding import PatchMesh, shard_system
    from goldfish_tpu_torch.solver import system as sy

    ds = shard_system(sys_.data, PatchMesh(None, 1, 2, dev))
    sh = ds.shard
    tab = sy.jet_tables(ds)
    d = sys_.zero_displacement() + 1e-3 * torch.randn(
        sys_.cp.shape, dtype=torch.float64, device=dev,
        generator=torch.Generator(dev).manual_seed(41)) * ds.free
    Hs = sy.jet_hessians(ds, d, sys_.cp, th(h0))
    H, R, gi, free = Hs.H_e, tab.R_e, tab.gi_e, tab.free
    N = free.shape[0]
    K = torch.zeros(N, N, dtype=torch.float64, device=dev)
    sy.jet_assemble(K, H, R, gi, free)
    Kp = torch.zeros_like(K)
    sy._assemble_plain(Kp, H, R, gi, free)
    v = torch.randn(N, dtype=torch.float64, device=dev,
                    generator=torch.Generator(dev).manual_seed(42))
    y = sy.jet_matvec(torch.zeros_like(v), H, R, gi, free, v)
    yp = torch.zeros_like(v)
    sy._matvec_plain(yp, H, R, gi, free, v)
    e3 = float((K - Kp).abs().max()) / float(Kp.abs().max())
    e4 = float((y - yp).abs().max()) / float(yp.abs().max())
    lo_dof = int(gi.min())
    say(f"[sharded] K3/K4 on rank 1's slice of 2 (dofs from {lo_dof} = "
        f"lo*C*3, lo {sh.lo}): max|K3 - plain|/max|K| {e3:.2e}, "
        f"max|K4 - plain|/max|Kv| {e4:.2e}")
    if not (lo_dof == sh.lo * sys_.stack.max_cp * 3 and e3 <= 1e-12
            and e4 <= 1e-12):
        raise RuntimeError(f"K3/K4 with offset dof maps: {e3:.2e} {e4:.2e}")


def phase_sharded(dev):
    """Phase 35: the patch split. (a) The full-width wing (N = 6600) on a
    one-rank gloo group in this process through `shard_system`, cold (the
    thickness leg's solve and adjoint, against phase 1's cold iteration)
    and one warm 1e-4 step (against the same step unsharded here); (b)
    `dryrun_multichip(2)` on this card: two rank processes, gloo on CUDA
    tensors, the reference's three legs and the full-width wing, each
    against the unsharded leg (J 1e-9, dJ 1e-6), every rank launching K1-K4
    and K13.
    Returns the launch counts of both parts."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.entry import dryrun_multichip
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.parallel.legs import thickness_eval
    from goldfish_tpu_torch.parallel.sharding import make_mesh

    t_phase = time.perf_counter()
    sys_ = wing.build(num_el=6, p=3, device=dev)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64,
                      device=dev)
    offset_map_checks(sys_, th, h0, dev)
    counts = {k: 0 for k in _cuda.COUNTERS}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh(device=dev)
            reset_counts()
            J, g, d, t_s = thickness_eval(sys_, 1, mesh, th, h0, 1e-9, 30)
            h1 = h0 * (1.0 + 1e-4)
            J1, g1, _, t_s1 = thickness_eval(sys_, 1, mesh, th, h1, 1e-9,
                                             30, d0=d)
            # the two sharded calls' launches, read once before the
            # unsharded calls below launch more
            counts.update(_cuda.launch_counts)
            Ju, gu, _, t_u = thickness_eval(sys_, 1, None, th, h0, 1e-9, 30)
            Ju1, gu1, _, t_u1 = thickness_eval(sys_, 1, None, th, h1, 1e-9,
                                               30, d0=d)
        finally:
            dist.destroy_process_group()
    eJ = abs(float(J) - MAIN_COLD["J"]) / abs(MAIN_COLD["J"])
    eg = rel_err(g.cpu(), MAIN_COLD["g"])[0]
    eJ1 = abs(float(J1) - float(Ju1)) / abs(float(Ju1))
    eg1 = rel_err(g1.cpu(), gu1.cpu())[0]
    say(f"[sharded] wing20 at 1 rank: cold {t_s:.3f} s (unsharded here "
        f"{t_u:.3f} s, phase 1 {MAIN_COLD['wall']:.3f} s; overhead "
        f"{t_s / t_u - 1:+.1%}), J rel {eJ:.2e}, dJ/dh_ffd rel {eg:.2e} "
        f"against phase 1's cold iteration; warm 1e-4 step {t_s1:.3f} s "
        f"(unsharded {t_u1:.3f} s, overhead {t_s1 / t_u1 - 1:+.1%}), J rel "
        f"{eJ1:.2e}, dJ rel {eg1:.2e}")
    if not (eJ <= 1e-9 and eg <= 1e-6 and eJ1 <= 1e-9 and eg1 <= 1e-6):
        raise RuntimeError(f"sharded wing20 at 1 rank: J {eJ:.2e} / "
                           f"{eJ1:.2e}, dJ {eg:.2e} / {eg1:.2e}")
    del sys_, d
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = dryrun_multichip(2, legs=("wing", "boxwing", "mi", "wing_full"),
                           timeout_s=240)
    t_dry = time.perf_counter() - t0
    for name, r in res.items():
        yard = JAX_MULTICHIP_DJ.get(name)
        ar = r["allreduce_ms"][0]
        say(f"[sharded] {name} at 2 ranks: J rel {r['rel_J']:.2e}, dJ rel "
            f"{r['rel_g']:.2e} (JAX on 8 CPU devices: "
            f"{'n/a' if yard is None else f'{yard:.2e}'}); wall sharded "
            f"{r['wall_sharded']:.3f} s, unsharded {r['wall_unsharded']:.3f}"
            f" s; one all-reduce of K {ar[0]:.2f} ms, of K v {ar[1]:.3f} ms")
        for rank, c in enumerate(r["counts"]):
            for k, n in c.items():
                counts[k] += n
            say(f"[sharded] {name} rank {rank} launches "
                f"{ {k: c[k] for k in K1_TO_K4 + CHOL} }")
            missing = [k for k in K1_TO_K4 + CHOL if c[k] == 0]
            if missing:
                raise RuntimeError(f"{name}: rank {rank} never launched "
                                   f"{missing}")
    say(f"[sharded] launch counts {counts}")
    say(f"[sharded] phase 35 {time.perf_counter() - t_phase:.1f} s "
        f"(dryrun_multichip(2) {t_dry:.1f} s)")
    return counts


def main():
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    guard_cholesky_solve()
    guard_cholesky_ex()
    phase_k2_bits(dev)
    phase_k13_bits(dev)
    record_k4_shapes()
    from goldfish_tpu_torch.models import tbeam, wing

    with open(REF_TUBE) as fh:
        ref_tube = json.load(fh)
    t0 = time.perf_counter()
    sys_ = wing.build(num_el=6, p=3, device=dev)
    P, C = sys_.stack.n_patches, sys_.stack.max_cp
    say(f"[setup] wing20 built in {time.perf_counter() - t0:.1f} s: "
        f"P={P} C={C} N={P * C * 3} stack {tuple(sys_.stack.R00.shape)} "
        f"ifs {tuple(sys_.ifs.RA00.shape)}")
    checks = phase_kernels(sys_)
    counts, fac = phase_main_path(sys_, dev)
    library = time_library("wing20", fac)
    del sys_, fac
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mi_sys = tbeam.build_mi(num_el=40, p=3, n_pts=17, device=dev)
    P, C = mi_sys.stack.n_patches, mi_sys.stack.max_cp
    say(f"[setup] MI T-beam built in {time.perf_counter() - t0:.1f} s: "
        f"P={P} C={C} N={P * C * 3} stack {tuple(mi_sys.stack.R00.shape)} "
        f"seam (I, N)=({mi_sys.mi.n_int}, {mi_sys.mi.n_max})")
    phase_mi_kernels(mi_sys, checks)
    counts_mi, fac = phase_mi_main(mi_sys, dev)
    library += time_library("mi_tbeam40", fac, mi_sys.c2x)
    del mi_sys, fac
    torch.cuda.empty_cache()
    with open(REF_OM_MI) as fh:
        ref_om_mi = json.load(fh)
    counts_om_mi, prob40 = phase_om_mi(dev, ref_om_mi["full"])
    torch.cuda.empty_cache()
    DESIGN_COUNTS["design_om_mi"] = phase_design_tangents(dev, ref_om_mi,
                                                          prob40)
    del prob40
    torch.cuda.empty_cache()
    with open(REF_5B) as fh:
        ref_5b = json.load(fh)
    t0 = time.perf_counter()
    counts_evtol = phase_evtol_mi(dev, checks, ref_5b["evtol_card"])
    torch.cuda.empty_cache()
    counts_tube_om = phase_tube_om_mi(dev, ref_5b["tube_card"])
    torch.cuda.empty_cache()
    say(f"[om-mi-5b] phases 6c-6d {time.perf_counter() - t0:.1f} s")

    counts_tf, fac = phase_tube_fixed(dev, checks, ref_tube)
    library += time_library("tube16", fac)
    del fac
    torch.cuda.empty_cache()
    counts_tm, fac, c2x = phase_tube_mi(dev, checks, ref_tube)
    library += time_library("tube16_mi", fac, c2x)
    del fac, c2x
    torch.cuda.empty_cache()

    with open(REF_PLATE) as fh:
        ref_plate = json.load(fh)
    t0 = time.perf_counter()
    counts_pl, fac = phase_plate(dev, checks, ref_plate)
    library += time_library("plate32", fac)
    del fac
    torch.cuda.empty_cache()
    phase_plate_sibling(dev, ref_plate["sibling"])
    say(f"[plate] phases 10-11 {time.perf_counter() - t0:.1f} s; script so "
        f"far {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()

    from goldfish_tpu_torch.models import boxwing

    with open(REF_PEG) as fh:
        ref_peg = json.load(fh)
    t0 = time.perf_counter()
    s = boxwing.build(**PEG, device=dev)
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] pegasus-91 built in {time.perf_counter() - t0:.1f} s: P={P}"
        f" C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} ifs "
        f"{tuple(s.ifs.RA00.shape)} (E_max, Q, L) = "
        f"{tuple(s.stack.R00.shape[1:])}, interface qps Nq = "
        f"{s.ifs.RA00.shape[1]}")
    phase_pegasus_kernels(s, checks)
    del s
    torch.cuda.empty_cache()
    counts_pd, fac = phase_pegasus_dense(dev, ref_peg["dense"])
    library += time_library("pegasus91", fac)
    del fac
    torch.cuda.empty_cache()
    counts_pk, counts_probe, pre, n_dof = phase_pegasus_krylov(
        dev, ref_peg["dense"])
    library += time_library_pegasus(pre, n_dof)
    del pre
    torch.cuda.empty_cache()
    say(f"[pegasus] phases 13-15 {time.perf_counter() - t0:.1f} s")

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import vlm_aeroelastic_wing as demo

    with open(REF_VLM) as fh:
        ref_vlm = json.load(fh)
    t0 = time.perf_counter()
    reset_counts()
    phase_vlm_demo(dev, ref_vlm["demo"])
    # built under the counts: the coupled build launches K5 for the
    # lattice's rows, once
    coupled = {"wing20": demo.build_coupled(**VLM_WIDE, device=dev)}
    d_wide = phase_vlm_wide(coupled["wing20"], ref_vlm["wing20"])
    counts_vlm = dict(_cuda.launch_counts)
    say_shapes("vlm")
    check_counts("vlm", counts_vlm, VLM_KERNELS + CHOL)
    coupled["demo"] = demo.build_coupled(**VLM_DEMO, device=dev)
    phase_vlm_kernels(coupled, checks)
    library += time_aic_solve(coupled["wing20"][0], d_wide)
    del coupled, d_wide
    torch.cuda.empty_cache()
    counts_slr = phase_slr(dev, ref_vlm["slr"], checks)
    say(f"[vlm] phases 16-19 {time.perf_counter() - t0:.1f} s")

    with open(REF_CONTACT) as fh:
        ref_contact = json.load(fh)
    t0 = time.perf_counter()
    got16 = phase_contact_kernels(dev)
    torch.cuda.empty_cache()
    counts_press, rows, counts_cfwd, dense32 = phase_press(
        dev, checks, ref_contact["press6"], got16)
    library += rows
    torch.cuda.empty_cache()
    counts_riks, rows = phase_riks(dev, ref_contact["riks24"], checks)
    library += rows
    say(f"[contact] phases 20-22 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    with open(REF_CAD) as fh:
        ref_cad = json.load(fh)
    t0 = time.perf_counter()
    counts_vms = phase_vmstress(dev)
    counts_hole = phase_plate_hole(dev, checks, ref_cad["plate_hole_card"])
    counts_thp = phase_thickness_plate(dev, ref_cad["plate_card"])
    counts_evtol_cad = phase_evtol(dev, checks, ref_cad["evtol_card"])
    torch.cuda.empty_cache()
    counts_curved = phase_curved(dev, checks, ref_cad["curved_card"])
    counts_caddee = phase_caddee(dev, ref_cad["caddee_card"])
    say(f"[cad] phases 23-28 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    with open(REF_DRIVERS) as fh:
        ref_drv = json.load(fh)
    with open(REF) as fh:
        ref20 = json.load(fh)
    with open(REF_MI) as fh:
        ref_mi = json.load(fh)
    t0 = time.perf_counter()
    counts_wdrv = phase_wing_driver(dev, ref20, ref_drv["wing_card"])
    counts_csdl = phase_csdl(dev, ref_mi, ref_drv["csdl_card"])
    counts_demos = phase_demos_rest(dev, ref_drv)
    say(f"[drivers] phases 29-32 {time.perf_counter() - t0:.1f} s")

    with open(REF_ROUTES) as fh:
        ref_routes = json.load(fh)
    t0 = time.perf_counter()
    counts_stop = phase_tbeam_stop(dev, checks, ref_routes)
    torch.cuda.empty_cache()
    counts_pk32 = phase_press32_krylov(dev, checks, dense32,
                                       ref_contact["press6"])
    del dense32
    torch.cuda.empty_cache()
    say(f"[contact-routes] phases 33-34 {time.perf_counter() - t0:.1f} s")
    counts_sh = phase_sharded(dev)

    paths = {"wing": (counts, WING_KERNELS + CHOL
                      + ("chol_subst/diag_inv",)),
             "mi": (counts_mi, None),
             "om_mi": (counts_om_mi, None),
             "evtol_mi": (counts_evtol, None),
             "tube_om_mi": (counts_tube_om, None),
             "tube": (counts_tf, None), "tube_mi": (counts_tm, None),
             "plate": (counts_pl, None), "pegasus_dense": (counts_pd, None),
             "pegasus_krylov": (counts_pk, None), "vlm": (counts_vlm, None),
             "slr": (counts_slr, None), "press": (counts_press, None),
             "riks": (counts_riks, None), "vmstress": (counts_vms, None),
             "plate_hole": (counts_hole, None),
             "thickness_plate": (counts_thp, None),
             "evtol": (counts_evtol_cad, None),
             "curved_mi": (counts_curved, None),
             "caddee": (counts_caddee, None),
             "wing_driver": (counts_wdrv, None),
             "contact_fwd": (counts_cfwd, None),
             "tbeam_stop": (counts_stop, None),
             "press32_krylov": (counts_pk32, None),
             "sharded": (counts_sh, None),
             **{k: (c, None) for k, c in counts_csdl.items()},
             **{k: (c, None) for k, c in counts_demos.items()},
             **{k: (c, None) for k, c in DESIGN_COUNTS.items()}}
    checks.update(K13)
    checks.update(K14)
    say(f"[k13] phase {K13_SECONDS[0]:.1f} s over the factors")
    say(f"[k14] phase {K14_SECONDS[0]:.1f} s over the factors")
    record = {"kernels": []}
    for name, src, rep in KERNELS:
        per = {f"launches_{p}": (c.get(name, 0) if keep is None
                                 or name in keep else 0)
               for p, (c, keep) in paths.items()}
        record["kernels"].append(
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": sum(per.values()), **per,
             # not a main path: the GMRES probe of the preconditioners
             "launches_pegasus_probe": counts_probe.get(name, 0),
             "max_abs_err": checks[name]["max_abs_err"],
             "ms": checks[name]["ms"], "plain_ms": checks[name]["plain_ms"],
             "bound_ms": checks[name]["bound_ms"],
             "bound_by": checks[name]["bound_by"],
             "library_ms": checks[name].get("library_ms"),
             **{k: v for k, v in checks[name].items()
                if k.startswith(("ms_", "plain_ms_", "bound_ms_"))}})
    say(json.dumps({"library": library}))
    say(f"[smoke] total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
