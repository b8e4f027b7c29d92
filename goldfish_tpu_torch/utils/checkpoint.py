"""Optimization checkpoints.

Port of goldfish_tpu/utils/checkpoint.py's `Checkpointer`: every optimizer
iteration can atomically persist the design vector, the warm-start state,
the iteration counter and the objective. `attach` wires it into the port's
`OptProblem.iter_callback`, whose design tensors may lie on the card; they
are copied to the host here. The reference's `resume_run` drives
`OptProblem.run` (the pyOptSparse route), which the port does not have yet
(ROADMAP Queue A11), so it is not ported.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

__all__ = ["Checkpointer"]


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
