"""Driver entry point: one damped-Newton update on the flagship model.

Port of `__graft_entry__.entry`: `entry()` returns `(fn, example_args)`,
`fn(data, cp, h, d) -> (d_new, |r|)` being one Newton update on the small
4-patch wing (`wing.build(n_chord=2, n_span=2, num_el=2, p=2)`): the
residual, the tangent K (the shell and penalty jet Hessians, kernel K1 and
K2 mode b, assembled by K3), the Cholesky solve of the diagonally
equilibrated K, and the update masked to the free dofs. It is the
per-iteration step of the hot loop, on the card by default.

    from goldfish_tpu_torch.entry import entry
    fn, args = entry()
    d_new, r_norm = fn(*args)

The multi-chip dry run of the JAX package (`dryrun_multichip`) is not
ported here (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import torch

__all__ = ["entry", "newton_update"]


@torch.no_grad()
def newton_update(data, cp, h, d):
    """(d_new, |r|): d_new = d + free * K^-1 (-r) at d."""
    from goldfish_tpu_torch.solver.system import assemble_K, residual

    r = residual(data, d, cp, h)
    K = assemble_K(data, d, cp, h)
    s = torch.rsqrt(K.diagonal().abs())
    L, info = torch.linalg.cholesky_ex(s[:, None] * K * s[None, :])
    if int(info) != 0:
        raise RuntimeError(f"the tangent is not positive definite "
                           f"(cholesky_ex info {int(info)})")
    b = -r.reshape(-1, 1)
    delta = s[:, None] * torch.cholesky_solve(s[:, None] * b, L)
    d_new = d + delta.reshape(r.shape) * data.free
    return d_new, torch.linalg.norm(r)


def entry(device=None):
    """(fn, example_args): `newton_update` and (data, cp, h, d = 0) of the
    small 4-patch wing on `device` (the current CUDA device by default)."""
    from goldfish_tpu_torch.models import wing

    sys_ = wing.build(n_chord=2, n_span=2, num_el=2, p=2, device=device)
    return newton_update, (sys_.data, sys_.cp, sys_.h_init,
                           sys_.zero_displacement())
