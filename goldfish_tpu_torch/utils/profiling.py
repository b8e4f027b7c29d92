"""Stage timers with device synchronization, and optional device traces.

Port of goldfish_tpu/utils/profiling.py (`Profiler`, `profiler`,
`force_readback`). A stage's clock stops after `torch.cuda.synchronize()`
when the card was used, so a stage times execution, not the enqueueing of
kernels. `stage(name, trace=True)` also records the stage with
`torch.profiler.profile` (CPU and, where CUDA is available, device
activity) and writes a Chrome trace into `trace_dir`.

    from goldfish_tpu_torch.utils.profiling import profiler
    with profiler.stage("solve"):
        d = solve(cp, h, d0)
    print(profiler.summary())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["Profiler", "profiler", "force_readback"]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def force_readback(tree):
    """Wait for the device work behind every tensor of `tree` (a tensor,
    or nested dicts, lists and tuples of them): synchronize each CUDA
    device they lie on. Returns the sum of their first elements (a host
    float; what the reference's readback fence returns)."""
    total, synced = 0.0, set()
    for t in _tensors(tree):
        if t.is_cuda and t.device not in synced:
            torch.cuda.synchronize(t.device)
            synced.add(t.device)
        if t.numel():
            total += float(t.detach().reshape(-1)[0])
    return total


class Profiler:
    def __init__(self, trace_dir: str | None = None):
        self.records = defaultdict(list)
        self.trace_dir = trace_dir
        self.enabled = True
        self.traces: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None, trace: bool = False):
        """Time a stage. The clock stops after the card has finished the
        stage's work (`torch.cuda.synchronize()` when CUDA is initialized)
        and after `force_readback` of `sync`, or of what the stage put in
        the yielded box's item 0. With `trace` and a `trace_dir`, the
        stage runs under `torch.profiler.profile` and its Chrome trace is
        written to `trace_dir/<name>_<n>.json`."""
        if not self.enabled:
            yield [None]
            return
        prof = None
        if trace and self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            box = [None]
            yield box
            for what in (box[0], sync):
                if what is not None:
                    force_readback(what)
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        self.records[name].append(time.perf_counter() - t0)
        if prof is not None:
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir,
                                f"{name}_{len(self.records[name])}.json")
            prof.export_chrome_trace(path)
            self.traces.append(path)

    def summary(self) -> str:
        lines = [f"{'stage':30s} {'calls':>6s} {'total s':>10s} "
                 f"{'mean ms':>10s} {'last ms':>10s}"]
        for name, ts in sorted(self.records.items()):
            tot = sum(ts)
            lines.append(f"{name:30s} {len(ts):6d} {tot:10.3f} "
                         f"{1e3 * tot / len(ts):10.2f} {1e3 * ts[-1]:10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.records.clear()
        self.traces.clear()


profiler = Profiler()
