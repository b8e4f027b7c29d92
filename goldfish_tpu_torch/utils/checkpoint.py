"""Optimization checkpoints and process-death-safe resumption.

Port of goldfish_tpu/utils/checkpoint.py (`Checkpointer`, `resume_run`):
every optimizer iteration can atomically persist the design vector, the
warm-start state, the iteration counter and the objective. `attach` wires
it into the port's `OptProblem.iter_callback`, whose design tensors may lie
on the card; they are copied to the host here. `resume_run` restores the
design and the warm-start state (as a tensor on the problem's device) from
a snapshot and runs only the remaining iterations.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

__all__ = ["Checkpointer", "resume_run"]


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


class Checkpointer:
    def __init__(self, path: str, every: int = 1):
        self.path = path
        self.every = max(int(every), 1)
        self._count = 0

    def save(self, design: dict, state=None, meta: dict | None = None):
        """Atomic snapshot (write-to-temp + rename)."""
        self._count += 1
        if self._count % self.every:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        payload = {f"design__{k}": _host(v) for k, v in design.items()}
        if state is not None:
            payload["state"] = _host(state)
        payload["meta"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".",
                                   suffix=".npz.tmp")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load(self):
        """Returns (design dict, state or None, meta dict) or None."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            design = {k[len("design__"):]: z[k] for k in z.files
                      if k.startswith("design__")}
            state = z["state"] if "state" in z.files else None
            meta = json.loads(bytes(z["meta"]).decode()) \
                if "meta" in z.files else {}
        return design, state, meta

    def attach(self, prob, state_box=None, start_iter=0):
        """Wire into OptProblem.iter_callback (saves each iteration).
        Chains with any callback already installed; `start_iter` keeps
        the persisted iteration counter monotonic across resumes."""
        it = [int(start_iter)]
        prev_cb = prob.iter_callback

        def cb(xdict, J):
            it[0] += 1
            self.save(xdict,
                      state=None if state_box is None else state_box[0],
                      meta={"iter": it[0], "J": float(J)})
            if prev_cb is not None:
                prev_cb(xdict, J)

        prob.iter_callback = cb
        return prob


def resume_run(prob, ckpt: Checkpointer, maxiter=100, state_box=None,
               **run_kwargs):
    """Process-death-safe optimization entry point: call it instead of
    `prob.run(...)`. If `ckpt` holds a snapshot of an earlier (killed)
    process, the design variables restart from it, its warm-start state
    goes into `state_box` (the problem's own `state_box` by default) as a
    tensor on the problem's device, and only the remaining `maxiter - done`
    iterations run, each snapshotted again. A snapshot whose iterations
    already reach `maxiter` only restores: the result is its design and its
    objective (the iteration callback records the scaled objective, so it
    is divided by the problem's objective scaler, as `run` does).

    Returns (result, iterations done by earlier processes)."""
    if state_box is None:
        state_box = getattr(prob, "state_box", None)
    done = 0
    snap = ckpt.load()
    if snap is not None:
        design, state, meta = snap
        for dv in prob._dvs:
            if dv.name in design:
                dv.init = np.asarray(design[dv.name], dtype=np.float64
                                     ).reshape(dv.init.shape)
        if state is not None and state_box is not None:
            like = state_box[0]
            dev = like.device if isinstance(like, torch.Tensor) \
                else getattr(prob, "device", "cpu")
            dtype = like.dtype if isinstance(like, torch.Tensor) \
                else torch.float64
            state_box[0] = torch.tensor(np.asarray(state), dtype=dtype,
                                        device=dev)
        done = int(meta.get("iter", 0))
    if snap is not None and done >= int(maxiter):
        # the budget is spent: restore only (a supervising retry loop would
        # otherwise overrun maxiter one iteration at a time)
        from goldfish_tpu_torch.opt.problem import OptResult

        design, _, meta = snap
        obj_scaler = float(getattr(prob, "_obj_scaler", 1.0) or 1.0)
        return OptResult(
            x={k: np.asarray(v) for k, v in design.items()},
            fun=float(meta.get("J", np.nan)) / obj_scaler,
            nit=0, success=True,
            message=f"resume: {done} >= maxiter={int(maxiter)} "
                    "iterations already completed", history=[]), done
    ckpt.attach(prob, state_box=state_box, start_iter=done)
    res = prob.run(maxiter=int(maxiter) - done, **run_kwargs)
    return res, done
