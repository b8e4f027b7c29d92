"""Multi-GPU execution: the patch axis split over torch.distributed ranks.

Port of goldfish_tpu/parallel/sharding.py. The reference's parallelism is
the patch: its MPI ranks own patches, and the JAX package shards every
(P, ...) array over a device mesh and lets GSPMD insert the gathers and
psums. Here each rank is one process with one `torch.distributed` group:

  - `shard_system` gives a rank the quadrature tables of its own block
    [lo, hi) of the (padded) patch axis, the heavy (P, E, Q, L) tables,
    and its own block of the interfaces; d, cp, h, `free`, E, nu, the
    loads, the dense tangent and its factor stay whole on every rank;
  - the operators of solver/system.py (and solver/system_mi.py) see the
    `PatchShard` on `SystemData.shard`, launch their kernels on the
    rank's slice with dof maps offset by lo*C*3, and sum the global-shaped
    result with ONE all-reduce per operator call (`PatchMesh.sum`);
  - every host decision of the solves (line search, floor stops,
    refactors, sweep counts) then reads all-reduced or replicated values,
    so all ranks take the same branch (see `PatchMesh.check_agree`).

Patch counts are padded to a multiple of the rank count with phantom
patches (`pad_system`): patch 0's geometry with zero quadrature weights,
zero masks and fully fixed dofs, so they add exact zeros everywhere and
the tangent keeps a unit diagonal on their dofs.

The reference's `state_sharding` (a NamedSharding for (P, C, ...) states)
has no counterpart: states are replicated on every rank here.

Backends: the tests and the one-card runs use gloo, which takes CUDA
tensors for `all_reduce` (staged through the host). NCCL does not take two
ranks on one device; a machine with one GPU per rank may pass
`backend="nccl"` to `maybe_init_distributed`, which is not exercised in
this repository's runs.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from goldfish_tpu_torch.config import as_device
from goldfish_tpu_torch.solver.system import SystemData

__all__ = ["maybe_init_distributed", "make_mesh", "padded_patch_count",
           "pad_system", "pad_patch_array", "pad_state", "system_shardings",
           "shard_system", "split_block", "PatchMesh", "PatchShard",
           "DEFAULT_TIMEOUT_S"]

# every process group gets a finite timeout: a rank that dies or takes
# another branch makes its peers raise instead of hang
DEFAULT_TIMEOUT_S = 120.0

_initialized = False


def _env_first(env, *names):
    for n in names:
        v = env.get(n)
        if v not in (None, ""):
            return v
    return None


def maybe_init_distributed(coordinator=None, num_processes=None,
                           process_id=None, env=None, backend="gloo",
                           timeout_s=DEFAULT_TIMEOUT_S) -> bool:
    """Guarded multi-process entry point (the role of the reference's MPI
    world). Reads the cluster spec, explicit arguments first, then

      coordinator:   GOLDFISH_COORDINATOR, else MASTER_ADDR:MASTER_PORT
      num_processes: GOLDFISH_NUM_PROCESSES, else WORLD_SIZE
      process_id:    GOLDFISH_PROCESS_ID, else RANK

    and calls `torch.distributed.init_process_group(backend,
    init_method=..., world_size=, rank=, timeout=timeout_s)`. A coordinator
    "host:port" becomes "tcp://host:port"; one with a scheme ("tcp://",
    "file://") is passed as it is. Returns False (and does nothing) when
    unconfigured or single-process; True for a configured process, also on
    a second call, which does not initialize again."""
    global _initialized
    env = os.environ if env is None else env
    if coordinator is None:
        coordinator = _env_first(env, "GOLDFISH_COORDINATOR")
        if coordinator is None and _env_first(env, "MASTER_ADDR") \
                and _env_first(env, "MASTER_PORT"):
            coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_first(env, "GOLDFISH_NUM_PROCESSES",
                                   "WORLD_SIZE")
    if process_id is None:
        process_id = _env_first(env, "GOLDFISH_PROCESS_ID", "RANK")
    if coordinator is None or num_processes is None:
        return False
    if int(num_processes) <= 1:
        return False
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    if process_id is None:
        raise ValueError("maybe_init_distributed: a cluster of "
                         f"{num_processes} processes needs a process id")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=init, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    _initialized = True
    return True


def _require_group():
    if not dist.is_initialized():
        # no fallback: a sharded operator never evaluates unsharded
        raise RuntimeError("the patch-sharded path needs an initialized "
                           "torch.distributed process group")


class PatchMesh(NamedTuple):
    """One rank's view of the patch split: its process group (None = the
    default group), rank, world size and device. `check` turns on the
    decision guard (`check_agree`); `make_mesh` sets it from the one switch
    of that guard, the environment variable GOLDFISH_SHARD_CHECK=1."""

    group: object
    rank: int
    world_size: int
    device: torch.device
    check: bool = False

    def sum(self, *ts):
        """All-reduce (SUM) of the tensors with ONE collective: one tensor
        is reduced in place, several are packed into one buffer. Returns
        the sums in the same shapes (the tensor itself for one argument).
        gloo stages CUDA tensors through the host. One rank's sum is the
        tensors themselves: no collective, no copy."""
        _require_group()
        if self.world_size == 1:
            return ts[0] if len(ts) == 1 else ts
        op = dist.ReduceOp.SUM
        if len(ts) == 1 and ts[0].is_contiguous() and ts[0].dim() > 0:
            dist.all_reduce(ts[0], op=op, group=self.group)
            return ts[0]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=op, group=self.group)
        out, k = [], 0
        for t in ts:
            out.append(flat[k:k + t.numel()].reshape(t.shape))
            k += t.numel()
        return out[0] if len(ts) == 1 else tuple(out)

    def all_true(self, flag: bool) -> bool:
        """True when `flag` holds on every rank (one all-reduce): for a
        decision whose input is rank-local."""
        _require_group()
        if self.world_size == 1:
            return bool(flag)
        t = torch.tensor([0.0 if flag else 1.0], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, group=self.group)
        return float(t) == 0.0

    def check_agree(self, where: str, *values):
        """Debug guard of every host decision: the values (floats, or
        0-dim/1-element tensors) must have the same bits on all ranks, read
        by an all-reduce MAX and MIN of their bit patterns. A decision that
        reads a rank-local value would part the ranks, and the next
        collective would hang. A no-op unless `check` is set."""
        if not self.check or self.world_size == 1:
            return
        _require_group()
        x = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device).view(torch.int64)
        hi, lo = x.clone(), x.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.group)
        if not torch.equal(hi, lo):
            raise RuntimeError(
                f"rank {self.rank}: ranks disagree at {where}: "
                f"{[float(v) for v in values]} (max bits {hi.tolist()}, "
                f"min bits {lo.tolist()})")


def split_block(n: int, rank: int, world_size: int):
    """[a, b): rank's contiguous block of n items split by count (block
    sizes differ by at most one). The rule that assigns interfaces and
    moving seams to ranks."""
    return rank * n // world_size, (rank + 1) * n // world_size


class PatchShard(NamedTuple):
    """A rank's part of a patch-sharded SystemData: its patch block [lo,
    hi) of the n_patches (padded) patches, its block [if_lo, if_hi) of the
    fixed interfaces, the mesh and, on rank 0 of a system with contact, the
    contact patches' copy (`contact_stack`, the patches `contact_ids` in
    the order of the renumbered pairs `contact`)."""

    lo: int
    hi: int
    n_patches: int
    if_lo: int
    if_hi: int
    mesh: PatchMesh
    contact: object = None
    contact_ids: torch.Tensor | None = None
    contact_stack: object = None

    def local(self, t):
        """The rank's rows of a global (P, ...) tensor (None stays None)."""
        return None if t is None else t[self.lo:self.hi]

    def place(self, t):
        """The rank's rows t in a global (P, ...) tensor of zeros (by
        torch.cat, so forward- and reverse-mode AD pass through)."""
        rest = tuple(t.shape[1:])
        return torch.cat([t.new_zeros((self.lo,) + rest), t,
                          t.new_zeros((self.n_patches - self.hi,) + rest)])

    def sum(self, *ts):
        """The tensors summed over the ranks (`PatchMesh.sum`)."""
        return self.mesh.sum(*ts)

    @property
    def rank0(self) -> bool:
        """Whether this rank evaluates the terms the split does not divide
        (the point and edge loads, contact)."""
        return self.mesh.rank == 0

    @property
    def patch_ids(self):
        """Global numbers of the rank's patches, lo..hi-1."""
        return torch.arange(self.lo, self.hi, device=self.mesh.device)

    def contact_rows(self, *ts):
        """The contact patches' rows of global (P, ...) tensors."""
        return tuple(t[self.contact_ids] for t in ts)

    def add_contact(self, r, rc):
        """r plus the contact patches' rows rc, placed at their patches."""
        return r.index_add(0, self.contact_ids, rc)

    def block(self, n: int):
        """The rank's [a, b) of n items (`split_block`)."""
        return split_block(n, self.mesh.rank, self.mesh.world_size)

    @property
    def contact_bytes(self) -> int:
        """Bytes of rank 0's copy of the contact patches' tables."""
        if self.contact_stack is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self.contact_stack)


def make_mesh(group=None, device=None) -> PatchMesh:
    """The patch mesh of this process: rank and world size of `group`
    (default: the default group), on `device` (the current CUDA device
    unless device="cpu"; two ranks may share one card), with the decision
    guard on where GOLDFISH_SHARD_CHECK=1. Raises when no process group is
    initialized."""
    _require_group()
    check = os.environ.get("GOLDFISH_SHARD_CHECK", "") == "1"
    dev = as_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return PatchMesh(group=group, rank=dist.get_rank(group),
                     world_size=dist.get_world_size(group), device=dev,
                     check=check)


def padded_patch_count(n_patches: int, n_ranks: int) -> int:
    """Phantom-padded patch count: the smallest multiple of the rank count
    >= n_patches, so every rank holds the same number of patches."""
    assert n_patches >= 1 and n_ranks >= 1
    return int(-(-n_patches // n_ranks) * n_ranks)


def _pad_leading(x, P_new, mode):
    """Pad axis 0 to P_new: "repeat" replicates entry 0, "zero" pads
    zeros."""
    k = P_new - x.shape[0]
    if k <= 0:
        return x
    if mode == "repeat":
        filler = x[:1].expand((k,) + tuple(x.shape[1:]))
    else:
        filler = x.new_zeros((k,) + tuple(x.shape[1:]))
    return torch.cat([x, filler], dim=0)


def pad_patch_array(x, P_old, P_new, mode="repeat"):
    assert x.shape[0] == P_old
    return _pad_leading(x, P_new, mode)


def pad_state(x, P_new, mode="repeat"):
    """Pad a (P, C, ...) state or coefficient tensor (cp: "repeat" keeps
    real geometry under the phantom patches; d and h: either works).
    Differentiable (torch.cat)."""
    return _pad_leading(x, P_new, mode)


def pad_system(data: SystemData, P_new: int) -> SystemData:
    """Append phantom patches: patch 0's tables (R00..R02, conn) repeated,
    zero quadrature weights, zero cp_mask and `free`, E and nu repeated,
    the dead, follower-pressure and field loads zero. The point loads, the
    edge loads and contact name patches by number, so they pass through
    unchanged."""
    st = data.stack
    P = st.n_patches
    if P_new == P:
        return data
    assert P_new > P and data.shard is None
    rep = lambda x: _pad_leading(x, P_new, "repeat")   # noqa: E731
    zero = lambda x: None if x is None else _pad_leading(  # noqa: E731
        x, P_new, "zero")
    stack = st._replace(
        R00=rep(st.R00), R10=rep(st.R10), R01=rep(st.R01), R20=rep(st.R20),
        R11=rep(st.R11), R02=rep(st.R02), conn=rep(st.conn), wq=zero(st.wq),
        cp_mask=zero(st.cp_mask))
    return data._replace(stack=stack, free=zero(data.free), E=rep(data.E),
                         nu=rep(data.nu), f_areal=zero(data.f_areal),
                         pressure=zero(data.pressure),
                         f_field=zero(data.f_field))


def system_shardings(data: SystemData, mesh: PatchMesh | None = None):
    """Placement of each leaf of `data` under `shard_system`, by dotted
    name: "patch" (split by patch block: the stack's tables), "interface"
    (split by interface block: the interface stack) or "replicated"
    (everything else, `free`, E, nu and the loads included; the JAX
    package splits every (P, ...) leaf, the port keeps the small
    per-patch vectors whole, since the dense tangent reads them whole)."""
    out = {}
    for name, val in zip(SystemData._fields, data):
        if name == "shard" or val is None:
            continue
        if isinstance(val, tuple) and hasattr(val, "_fields"):
            kind = {"stack": "patch", "ifs": "interface"}.get(name,
                                                               "replicated")
            for f in val._fields:
                out[f"{name}.{f}"] = kind
        else:
            out[name] = "replicated"
    return out


def _to(x, device):
    """A (nested) NamedTuple of tensors on `device`."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    return x


def _rows(nt, idx, device):
    """Rows idx (a slice or an index tensor) of every leaf of a NamedTuple
    of (n, ...) tensors, contiguous on `device`."""
    return type(nt)(*(v[idx].to(device).contiguous() for v in nt))


def shard_system(data: SystemData, mesh: PatchMesh) -> SystemData:
    """This rank's SystemData on `mesh.device`: the stack's rows [lo, hi)
    of the padded patch axis (P must be a multiple of the world size; see
    `pad_system`), the interfaces of `split_block(I, rank, world)` (None
    when the block is empty), the rest replicated, and the `PatchShard` on
    `shard`. Only the rank's rows are copied to the device, so a system
    built on the CPU never holds the whole stack on the card.

    Terms that the split does not divide are evaluated on rank 0 only: the
    point and edge loads, and contact, for which rank 0 keeps a copy of
    the contact patches' tables (`PatchShard.contact_bytes`)."""
    if data.shard is not None:
        raise ValueError("shard_system: data is already sharded")
    st = data.stack
    P, W, r = st.n_patches, mesh.world_size, mesh.rank
    if P % W:
        raise ValueError(f"shard_system: {P} patches over {W} ranks; pad "
                         "first (pad_system(data, padded_patch_count(P, "
                         "W)))")
    dev = mesh.device
    n = P // W
    lo, hi = r * n, (r + 1) * n
    ifs, (a, b) = None, (0, 0)
    if data.ifs is not None:
        a, b = split_block(data.ifs.n_interfaces, r, W)
        if b > a:
            ifs = _rows(data.ifs, slice(a, b), dev)
    contact = ids = cstack = None
    if data.contact is not None and r == 0:
        c = data.contact
        ids = torch.unique(torch.cat([c.pa, c.pb]).long())
        where = torch.full((P,), -1, dtype=torch.int64, device=ids.device)
        where[ids] = torch.arange(len(ids), device=ids.device)
        contact = _to(c._replace(pa=where[c.pa.long()].to(c.pa.dtype),
                                 pb=where[c.pb.long()].to(c.pb.dtype)), dev)
        cstack = _rows(st, ids.to(st.R00.device), dev)
        ids = ids.to(dev)
    shard = PatchShard(lo=lo, hi=hi, n_patches=P, if_lo=a, if_hi=b,
                       mesh=mesh, contact=contact, contact_ids=ids,
                       contact_stack=cstack)
    rest = _to(data._replace(stack=None, ifs=None), dev)
    return rest._replace(stack=_rows(st, slice(lo, hi), dev), ifs=ifs,
                         shard=shard)
