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
group itself. Where every rank of a gloo group holds the same card, the
collectives on that card's tensors move their bytes through staging
buffers all ranks map, and meet through a barrier table in host memory
(``launch.transport.SharedBuffers``), instead of through gloo; the
group then carries the tensors on the host (``transport=``: "auto",
"shared" or "group").

On a serving mesh only the EP data plane is multi-rank: embeddings,
attention, the KV cache, norms and the LM head run replicated on every
rank, as in the reference, where the mesh reaches only ``moe_ep_layer``.

One class, ``ProcessMesh``, holds a rank's place in any such grid of
ranks: its coordinates, its named groups (each the ranks that vary some
axes with the others fixed) and their collectives, with each
collective's host ms and bytes. ``ServingMesh`` is its (data, ep, tp)
form with the three groups above; ``make_process_mesh`` and
``make_host_mesh`` build its ("data", "model") form, with the data
groups of the ZeRO-2 and ZeRO-3 steps and the model groups of their
tensor parallelism (``models.model.make_train_step(grad_shardings=,
param_shardings=)``, ``make_prefill_step(param_shardings=)``). ``LogicalMesh``
(``make_production_mesh``) has axis sizes only, no devices and no
process group: the dry-run reckons per-rank bytes on it.

Every sharding function takes any object with ``.shape`` (axis name ->
size, in mesh order) and ``.axis_names``.
"""
from __future__ import annotations

import datetime
import hashlib
import itertools
import math
import os
import pickle
import tempfile
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.launch.transport import SharedBuffers

AXES = ("data", "ep", "tp")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the most any collective or the process-group rendezvous may wait
INIT_TIMEOUT_S = 60.0
HOW_TO_START = ("start one rank per device (launch.serve --host-devices "
                "N, launch.mesh.spawn_local, or torchrun --nproc-per-node "
                "N) and initialise the process group before this call")


@dataclass
class ProcessMesh:
    """This rank's place in a grid of ``torch.distributed`` ranks,
    ordered row-major over ``shape`` (axis name -> size, in mesh order),
    its device, and the collectives over its named groups. ``members``
    gives each group's member ranks (this rank's group, in group-rank
    order); a group of one rank has no process group and its collectives
    are identities. ``shared`` holds the staging buffers of ranks that
    share this rank's card (None: every collective runs on the process
    group). ``host_ms`` sums the host time of each collective by
    name (the transport meter), ``nbytes`` the bytes of its results; a
    name is "<collective>/<group>", with "/<tag>" where the caller tags
    what it moves."""
    shape: OrderedDict
    rank: int
    coords: tuple
    device: torch.device
    members: dict = field(default_factory=dict)
    groups: dict = field(default_factory=dict)
    host_ms: dict = field(default_factory=dict)
    nbytes: dict = field(default_factory=dict)
    shared: SharedBuffers | None = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def degrees(self) -> tuple:
        return tuple(self.shape.values())

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self.coords[self.axis_names.index(axis)]

    def group_size(self, name: str) -> int:
        return len(self.members.get(name, (self.rank,)))

    def _on_card(self, x) -> bool:
        return self.shared is not None and x.device == self.shared.device

    def _timed(self, name: str, t0: float, out, tag=None) -> None:
        if tag:
            name = f"{name}/{tag}"
        self.host_ms[name] = self.host_ms.get(name, 0.0) + \
            (time.perf_counter() - t0) * 1e3
        self.nbytes[name] = self.nbytes.get(name, 0) + \
            out.numel() * out.element_size()

    def all_gather(self, x, group: str, tag=None):
        """(n, *x.shape): every member's `x`, in group-rank order."""
        n = self.group_size(group)
        if n == 1:
            return x[None]
        t0 = time.perf_counter()
        if self._on_card(x):
            out = self.shared.all_gather(x, self.members[group])
        else:
            # gloo takes only the concatenated (flat) form
            out = x.new_empty((n * x.numel(),))
            dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                        group=self.groups[group])
        self._timed(f"all_gather/{group}", t0, out, tag)
        return out.view((n,) + tuple(x.shape))

    def all_to_all(self, x, group: str, tag=None):
        """Row block i of `x` (split evenly on dim 0) goes to member i;
        block j of the result came from member j."""
        if self.group_size(group) == 1:
            return x
        t0 = time.perf_counter()
        if self._on_card(x):
            out = self.shared.all_to_all(x, self.members[group])
        else:
            out = torch.empty_like(x, memory_format=torch.contiguous_format)
            dist.all_to_all_single(out, x.contiguous(),
                                   group=self.groups[group])
        self._timed(f"all_to_all/{group}", t0, out, tag)
        return out

    def all_reduce(self, x, group: str, op: str = "sum", tag=None):
        """The sum (or, with `op` "max", the maximum) of `x` over the
        group (a new tensor)."""
        if self.group_size(group) == 1:
            return x
        t0 = time.perf_counter()
        out = self._reduce(x, group, op)
        self._timed(f"all_reduce/{group}", t0, out, tag)
        return out

    def _reduce(self, x, group: str, op: str = "sum"):
        if self._on_card(x):
            return self.shared.all_reduce(x, self.members[group], op)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_OPS[op], group=self.groups[group])
        return out

    def all_reduce_autograd(self, x, group: str):
        """The sum of `x` over the group, differentiable: its backward
        sums the members' gradients the same way."""
        if self.group_size(group) == 1:
            return x
        t0 = time.perf_counter()
        out = _AllReduceSum.apply(x, self, group)
        self._timed(f"all_reduce_autograd/{group}", t0, out)
        return out

    def reduce_scatter(self, x, group: str, tag=None):
        """Member i receives block i of the sum over the group of `x`
        (n blocks of equal size on dim 0)."""
        n = self.group_size(group)
        if n == 1:
            return x
        t0 = time.perf_counter()
        shape = (x.shape[0] // n,) + tuple(x.shape[1:])
        if self._on_card(x):
            out = self.shared.reduce_scatter(
                x, self.members[group]).view(shape)
        else:
            out = x.new_empty(shape)
            dist.reduce_scatter_tensor(out, x.contiguous(),
                                       group=self.groups[group])
        self._timed(f"reduce_scatter/{group}", t0, out, tag)
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
                f"mesh: ranks {odd} hold a different {what} than rank 0; "
                f"every rank must run the same session")


class _AllReduceSum(torch.autograd.Function):
    """The group's sum, whose backward is the group's sum of the
    gradients."""

    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh._reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce(g, ctx.group), None, None


@dataclass
class ServingMesh(ProcessMesh):
    """A (data, ep, tp) ``ProcessMesh`` with the EP slot plane's three
    groups (module docstring)."""

    @property
    def shard(self) -> int:
        """This rank's token shard: data index * ep + ep index."""
        return self.coords[0] * self.shape["ep"] + self.coords[1]


TRANSPORTS = ("auto", "shared", "group")
# this process's staging buffers, by (default process group, device)
_SHARED: dict = {}


def shared_buffers(device, transport: str = "auto"):
    """This process's ``SharedBuffers`` for `device` (made at the first
    call, which every rank makes in one order), or None where the
    collectives stay on the process group: `transport` "group", one
    rank, or under "auto" a device that is not CUDA, a backend that is
    not gloo, or ranks on different cards. "shared" insists (on the CPU
    it maps files, which the tests use)."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport={transport!r} (expected one of "
                         f"{TRANSPORTS})")
    device = torch.device(device)
    if transport == "group" or not dist.is_initialized() or \
            dist.get_world_size() == 1:
        return None
    if transport == "auto" and (device.type != "cuda"
                                or dist.get_backend() != "gloo"):
        return None
    key = (id(dist.group.WORLD), str(device))
    if key not in _SHARED:
        _SHARED[key] = SharedBuffers.connect(
            device, require_same_card=transport == "shared")
    if _SHARED[key] is None and transport == "shared":
        raise RuntimeError("transport='shared' needs every rank on one card")
    return _SHARED[key]


def release_shared_buffers(*, meet: bool = True) -> None:
    """Drop this process's mapped staging buffers (with `meet`, once
    every rank has: call it on every rank before the process group
    ends)."""
    while _SHARED:
        bufs = _SHARED.popitem()[1]
        if bufs is not None:
            bufs.close(meet=meet)


def _build(cls, shape: OrderedDict, spans: dict, device,
           transport: str = "auto"):
    """A `cls` mesh of `shape` over the ranks of the initialised default
    process group (rank 0 of one without one). `spans` maps each group's
    name to the axes it varies: a group holds the ranks that share this
    rank's coordinates on the other axes, in row-major order. Every
    rank creates every group of more than one rank, in one order
    (``dist.new_group``'s rule), and its staging buffers under
    `transport` (``shared_buffers``)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    names, sizes = list(shape), list(shape.values())
    coords = tuple((rank // math.prod(sizes[i + 1:])) % sizes[i]
                   for i in range(len(sizes)))

    def rank_of(at: dict) -> int:
        r = 0
        for a, n in shape.items():
            r = r * n + at[a]
        return r

    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = cls(shape=shape, rank=rank, coords=coords,
               device=torch.device(device))
    for name, span in spans.items():
        fixed = [a for a in names if a not in span]
        for f in itertools.product(*(range(shape[a]) for a in fixed)):
            at = dict(zip(fixed, f))
            ranks = [rank_of({**at, **dict(zip(span, v))})
                     for v in itertools.product(*(range(shape[a])
                                                  for a in span))]
            if len(ranks) == 1:
                break
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh.members[name], mesh.groups[name] = ranks, g
    mesh.shared = shared_buffers(mesh.device, transport)
    return mesh


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
                      tp: int = 1, data: int = 1, device=None,
                      transport: str = "auto") -> ServingMesh:
    """("data", "ep", "tp") mesh for the EP serving hot path over the
    ranks of the initialised default process group (`devices`, when
    given, must equal its world size; without a process group only the
    one-rank mesh exists). `ep` defaults to devices // (data * tp); the
    factorisation must use exactly data * ep * tp ranks. `device` is
    where this rank's tensors live (default: the current CUDA device);
    `transport` picks how its collectives move bytes (module docstring,
    ``shared_buffers``). Every rank must call this, in the same order as
    its other group creations."""
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
    return _build(ServingMesh, OrderedDict(zip(AXES, degrees)),
                  {"ep": ("ep",), "tp": ("tp",), "shard": ("data", "ep")},
                  device, transport)


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


# ------------------------------------------------------ (data, model) meshes

MESH_AXES = ("data", "model")


@dataclass(frozen=True)
class LogicalMesh:
    """A mesh shape with no devices and no process group: what the
    dry-run shards over. ``shape`` maps each axis name to its size, in
    mesh order."""
    shape: OrderedDict
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False, shape=None):
    """The reference's production mesh as a ``LogicalMesh``: (16, 16)
    over ("data", "model"), or (2, 16, 16) with a leading "pod" axis.
    `shape` overrides the per-pod (data, model) factorisation, always of
    256. The port's dry-run uses it as a logical shape only: it reckons
    specs, bytes and FLOPs per rank of such a mesh and claims nothing
    about any hardware."""
    per_pod = tuple(shape) if shape else (16, 16)
    if per_pod[0] * per_pod[1] != 256:
        raise ValueError(f"a pod's (data, model) must use 256 ranks, got "
                         f"{per_pod}")
    sizes = ((2,) + per_pod) if multi_pod else per_pod
    axes = (("pod",) + MESH_AXES) if multi_pod else MESH_AXES
    return LogicalMesh(OrderedDict(zip(axes, sizes)), axes)


def dp_axes(mesh) -> tuple:
    """Logical data-parallel axes (pod is folded into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mp_axis(mesh) -> str:
    return "model"


def make_process_mesh(data: int, model: int = 1, *, device=None,
                      transport: str = "auto") -> ProcessMesh:
    """A (data, model) ``ProcessMesh`` over the ranks of the initialised
    default process group (without one, only the (1, 1) mesh exists);
    data * model must equal its world size. `device` is where this
    rank's tensors live (default: the current CUDA device); `transport`
    as for ``make_serving_mesh``. Every rank must call this, in the same
    order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = int(data), int(model)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"(data, model) = ({data}, {model}) does not "
                         f"factor the {world} rank(s) of this process "
                         f"group: {HOW_TO_START}")
    return _build(ProcessMesh, OrderedDict(zip(MESH_AXES, (data, model))),
                  {"data": ("data",), "model": ("model",)}, device,
                  transport)


def make_host_mesh(*, device=None) -> ProcessMesh:
    """The reference's single-process ("data", "model") mesh, (1, world)
    over the default group's ranks (one rank without one). It is not
    the EP serving mesh: ``moe_ep_layer`` needs ``make_serving_mesh``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_process_mesh(1, world, device=device)


# ------------------------------------------------------------ local ranks


def _rank_main(rank, fn, nprocs, backend, store, timeout_s, results, args):
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        release_shared_buffers()
        # plain pickle bytes: a tensor is copied, not shared through a
        # file descriptor that dies with this process
        results.put((rank, pickle.dumps(out)))
    finally:
        release_shared_buffers(meet=False)
        dist.destroy_process_group()


def spawn_local(fn, nprocs: int, *, backend: str, args=(),
                timeout_s: float = INIT_TIMEOUT_S,
                wall_s: float = 600.0, start_method: str = "spawn") -> list:
    """Run ``fn(rank, *args)`` in `nprocs` fresh local processes that
    form one process group over `backend` (a file rendezvous in a
    temporary directory; collectives wait at most `timeout_s`). `fn` must
    be importable by name (the start method pickles it). Returns each
    rank's result in rank order; a rank's exception is raised here, and
    the ranks are killed after `wall_s`. Build the CUDA kernels before
    calling this, so the ranks do not each run nvcc. `start_method`
    "forkserver" forks each rank from one server process, which imports
    what ``set_forkserver_preload`` names once (a fresh "spawn" process
    imports torch and the main module again, seconds a rank)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend={backend!r} (expected 'gloo' or 'nccl')")
    mp = torch.multiprocessing
    results = mp.get_context(start_method).SimpleQueue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, backend, store, timeout_s,
                              results, tuple(args)),
            nprocs=nprocs, join=False, start_method=start_method)
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
