"""Serving meshes of the PyTorch port: the reference's ("data", "ep",
"tp") mesh as ``torch.distributed`` process groups.

    mesh = make_serving_mesh(ep=4, device="cpu")   # in each of 4 ranks
    engine = ServingEngine(cfg, params, expert_runtime="on", mesh=mesh)

Ranks are ordered row-major over (data, ep, tp), as ``jax.make_mesh``
orders devices: rank ``(d * ep + e) * tp + t`` has coordinates (d, e, t),
and its token shard is ``d * ep + e``. Three groups serve the EP slot
plane (``distributed.ep.moe_ep_layer``):

  * the ep group: the ranks with this rank's data and tp index (the
    scatter and gather all-to-alls, the kept-count all-to-all);
  * the tp group: the ranks with this rank's data and ep index (the
    all-reduce of the FFN's partial sums over the split width);
  * the shard group: data x ep, the ranks with this rank's tp index (the
    count tables, the load and drop sums, the combined rows).

A group of one rank is never created; its collectives are identities, so
a (1, 1, 1) mesh needs no process group at all.

The backend is the caller's choice, made when the default group is
initialised: NCCL across cards; gloo on the CPU and where ranks share
one card (NCCL refuses two ranks on one device). ``spawn_local`` starts
N local ranks over gloo; under ``torchrun`` the caller initialises the
group itself.

Only the EP data plane is multi-rank: embeddings, attention, the KV
cache, norms and the LM head run replicated on every rank, as in the
reference, where the mesh reaches only ``moe_ep_layer``.

The reference's ``make_host_mesh``, ``make_production_mesh``, ``dp_axes``
and ``mp_axis`` serve its dry-run and its sharded training step; they
arrive with the port's dry-run slice (``distributed/sharding.py``).
"""
from __future__ import annotations

import datetime
import hashlib
import math
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

AXES = ("data", "ep", "tp")
# the most any collective or the process-group rendezvous may wait
INIT_TIMEOUT_S = 60.0
HOW_TO_START = ("start one rank per device (launch.serve --host-devices "
                "N, launch.mesh.spawn_local, or torchrun --nproc-per-node "
                "N) and initialise the process group before this call")


@dataclass
class ServingMesh:
    """This rank's place in a (data, ep, tp) serving mesh, its device,
    and the collectives of the EP slot plane over its three groups.
    ``host_ms`` sums the host time of each collective by name (the
    layer's transport meter)."""
    shape: dict
    rank: int
    coords: tuple
    device: torch.device
    groups: dict = field(default_factory=dict)   # 'ep' | 'tp' | 'shard'
    host_ms: dict = field(default_factory=dict)

    @property
    def degrees(self) -> tuple[int, int, int]:
        return tuple(self.shape[a] for a in AXES)

    @property
    def size(self) -> int:
        d, e, t = self.degrees
        return d * e * t

    @property
    def shard(self) -> int:
        """This rank's token shard: data index * ep + ep index."""
        return self.coords[0] * self.shape["ep"] + self.coords[1]

    def group_size(self, name: str) -> int:
        d, e, t = self.degrees
        return {"ep": e, "tp": t, "shard": d * e}[name]

    def _timed(self, name: str, t0: float) -> None:
        self.host_ms[name] = self.host_ms.get(name, 0.0) + \
            (time.perf_counter() - t0) * 1e3

    def all_gather(self, x, group: str):
        """(n, *x.shape): every member's `x`, in group-rank order (the
        mesh's rank order)."""
        n = self.group_size(group)
        if n == 1:
            return x[None]
        t0 = time.perf_counter()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        # gloo has no all_gather_into_tensor: gather into a list
        dist.all_gather(parts, x, group=self.groups[group])
        out = torch.stack(parts)
        self._timed(f"all_gather/{group}", t0)
        return out

    def all_to_all(self, x, group: str):
        """Row block i of `x` (split evenly on dim 0) goes to member i;
        block j of the result came from member j."""
        if self.group_size(group) == 1:
            return x
        t0 = time.perf_counter()
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(),
                               group=self.groups[group])
        self._timed(f"all_to_all/{group}", t0)
        return out

    def all_reduce(self, x, group: str):
        """The sum of `x` over the group (a new tensor)."""
        if self.group_size(group) == 1:
            return x
        t0 = time.perf_counter()
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.groups[group])
        self._timed(f"all_reduce/{group}", t0)
        return out

    def check_same(self, what: str, payload: bytes) -> None:
        """Raise on every rank unless all ranks hold the same `payload`
        (a digest of it crosses the world): ranks that diverge fail here
        instead of hanging later in a collective."""
        if self.size == 1:
            return
        word = int.from_bytes(hashlib.sha256(payload).digest()[:8], "little",
                              signed=True)
        mine = torch.tensor([word], dtype=torch.int64, device=self.device)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine)
        seen = [int(p) for p in parts]
        if len(set(seen)) > 1:
            odd = [r for r, v in enumerate(seen) if v != seen[0]]
            raise RuntimeError(
                f"serving mesh: ranks {odd} hold a different {what} than "
                f"rank 0; every rank must run the same session")


def _factor(n: int, ep, tp: int, data: int) -> tuple[int, int, int]:
    """The reference's factorisation rules and errors."""
    if ep is None:
        if n % (data * tp):
            raise ValueError(
                f"make_serving_mesh: {n} devices do not factor into "
                f"data={data} x ep x tp={tp}")
        ep = n // (data * tp)
    if data * ep * tp != n:
        raise ValueError(
            f"make_serving_mesh: data={data} x ep={ep} x tp={tp} "
            f"!= {n} devices")
    return data, ep, tp


def make_serving_mesh(devices: int | None = None, *, ep: int | None = None,
                      tp: int = 1, data: int = 1,
                      device=None) -> ServingMesh:
    """("data", "ep", "tp") mesh for the EP serving hot path over the
    ranks of the initialised default process group (`devices`, when
    given, must equal its world size; without a process group only the
    one-rank mesh exists). `ep` defaults to devices // (data * tp); the
    factorisation must use exactly data * ep * tp ranks. `device` is
    where this rank's tensors live (default: the current CUDA device).
    Every rank must call this, in the same order as its other group
    creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if devices is None else int(devices)
    if n != world:
        raise ValueError(
            f"make_serving_mesh: {n} devices requested but the process "
            f"group has {world} rank(s): {HOW_TO_START}")
    try:
        degrees = _factor(n, ep, int(tp), int(data))
    except ValueError as e:
        raise ValueError(f"{e}: {HOW_TO_START}") from None
    d_, e_, t_ = degrees
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = (rank // (e_ * t_), (rank // t_) % e_, rank % t_)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = ServingMesh(shape=dict(zip(AXES, degrees)), rank=rank,
                       coords=coords, device=torch.device(device))

    def at(d, e, t):
        return (d * e_ + e) * t_ + t

    # every rank creates every group, in one order (dist.new_group's rule)
    members = {
        "ep": [[at(d, e, t) for e in range(e_)]
               for d in range(d_) for t in range(t_)],
        "tp": [[at(d, e, t) for t in range(t_)]
               for d in range(d_) for e in range(e_)],
        "shard": [[at(d, e, t) for d in range(d_) for e in range(e_)]
                  for t in range(t_)],
    }
    for name, lists in members.items():
        if len(lists[0]) == 1:
            continue
        for ranks in lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[name] = g
    return mesh


def check_degrees(degrees) -> tuple[int, int, int]:
    """(data, ep, tp) degrees as ints, which must be positive and use
    exactly the ranks of the process group (one rank without one)."""
    degrees = tuple(int(v) for v in degrees)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if len(degrees) != 3 or min(degrees) < 1 or math.prod(degrees) != world:
        raise ValueError(
            f"(data, ep, tp) = {degrees} does not factor the {world} "
            f"rank(s) of this process group: {HOW_TO_START}")
    return degrees


def check_mesh(mesh) -> tuple[int, int, int]:
    """The (data, ep, tp) degrees of `mesh`: a ``ServingMesh``, or None
    for the one-process (1, 1, 1) plane."""
    if mesh is None:
        return 1, 1, 1
    if not isinstance(mesh, ServingMesh):
        raise ValueError(
            f"mesh must be a launch.mesh.ServingMesh (make_serving_mesh), "
            f"got {type(mesh).__name__}")
    return check_degrees(mesh.degrees)


# ------------------------------------------------------------ local ranks


def _rank_main(rank, fn, nprocs, backend, store, timeout_s, results, args):
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        # plain pickle bytes: a tensor is copied, not shared through a
        # file descriptor that dies with this process
        results.put((rank, pickle.dumps(fn(rank, *args))))
    finally:
        dist.destroy_process_group()


def spawn_local(fn, nprocs: int, *, backend: str, args=(),
                timeout_s: float = INIT_TIMEOUT_S,
                wall_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in `nprocs` fresh local processes that
    form one process group over `backend` (a file rendezvous in a
    temporary directory; collectives wait at most `timeout_s`). `fn` must
    be importable by name (the spawn start method pickles it). Returns
    each rank's result in rank order; a rank's exception is raised here,
    and the ranks are killed after `wall_s`. Build the CUDA kernels
    before calling this, so the ranks do not each run nvcc."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend={backend!r} (expected 'gloo' or 'nccl')")
    mp = torch.multiprocessing
    results = mp.get_context("spawn").SimpleQueue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, backend, store, timeout_s,
                              results, tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + wall_s
        try:
            while True:
                while not results.empty():
                    r, v = results.get()
                    out[r] = pickle.loads(v)
                if ctx.join(timeout=0.2):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn_local: {nprocs} ranks still running after "
                        f"{wall_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        while not results.empty():
            r, v = results.get()
            out[r] = pickle.loads(v)
    missing = sorted(set(range(nprocs)) - set(out))
    if missing:
        raise RuntimeError(f"spawn_local: ranks {missing} returned nothing")
    return [out[r] for r in range(nprocs)]
