"""Collectives of local ranks through buffers they all map.

Ranks that share one card cannot use NCCL (it refuses two ranks on one
device), and gloo moves a card's tensors through host memory: at
~0.4-1.2 GB/s a step that gathers a few GB waits seconds on the host.
``SharedBuffers`` moves the bytes on the card instead. Every rank owns
one staging buffer that every other rank has mapped (CUDA IPC on a card;
a shared file mapping on the CPU, which the tests use), and a collective
moves its tensor a chunk at a time:

  1. each member copies its chunk into its own buffer and waits for the
     copy to land (a stream synchronisation);
  2. the group meets (a barrier: no payload);
  3. each member reads what it needs from the members' buffers, device
     to device, reducing in group-rank order where the collective sums;
  4. it waits for its reads, and the group meets again, so no buffer is
     overwritten while another member still reads it.

The barrier is a table of counters in host memory every rank maps
(``HostBarrier``): a gloo barrier costs ~1-1.7 ms, a meet through the
table tens of microseconds, and a small collective is two meets. The
process group only sets the buffers up.

Sums run in the tensor's dtype in group-rank order, so every member of
an all-reduce holds the same bits, and a reduce-scatter's block equals
that block of the all-reduce.

    bufs = SharedBuffers.connect(device)   # every rank, in one order
    out = bufs.all_gather(x, members)

``launch.mesh`` builds one per process (``transport="auto"`` where every
rank of a gloo group holds the same card) and its ``ProcessMesh``
collectives call it for tensors on that device.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

# bytes of each rank's staging buffer: a collective larger than this
# moves in chunks of it (two meets a chunk)
STAGE_BYTES = 64 << 20
# the most a meet waits for a member (gloo's own bound in launch.mesh)
MEET_TIMEOUT_S = 60.0


class HostBarrier:
    """Barriers over any group of the world's ranks through an int64
    table in host memory every rank maps: entry (i, j) counts the
    barriers rank i has entered that include rank j, and only rank i
    writes row i. Ranks i and j enter their common barriers in one
    order (every rank runs the collectives in program order), so i may
    leave a barrier once every member j has entered as many common
    barriers with i as i has."""

    def __init__(self, table: np.ndarray, rank: int):
        self.table = table
        self.rank = rank

    @classmethod
    def connect(cls, root: str, rank: int, world: int) -> "HostBarrier":
        """Every rank calls this with the same directory `root` (the
        table's file, which rank 0 creates and the caller removes)."""
        path = os.path.join(root, "barrier")
        if rank == 0:
            np.zeros((world, world), np.int64).tofile(path)
        dist.barrier()
        table = np.memmap(path, dtype=np.int64, mode="r+",
                          shape=(world, world))
        return cls(table, rank)

    def wait(self, members) -> None:
        me, t = self.rank, self.table
        others = [j for j in members if j != me]
        for j in others:
            t[me, j] += 1
        deadline, polls = None, 0
        for j in others:
            want = t[me, j]
            while t[j, me] < want:
                polls += 1
                if polls < 1000:
                    time.sleep(0)
                    continue
                time.sleep(5e-5)
                now = time.monotonic()
                deadline = deadline or now + MEET_TIMEOUT_S
                if now > deadline:
                    raise RuntimeError(
                        f"SharedBuffers: rank {j} did not reach a barrier "
                        f"with rank {me} in {MEET_TIMEOUT_S:.0f} s")


class SharedBuffers:
    """This rank's view of every rank's staging buffer (world rank ->
    uint8 tensor on `device`) and of the ranks' barrier table."""

    def __init__(self, bufs: list, rank: int, device: torch.device,
                 barrier: HostBarrier):
        self.bufs = bufs
        self.rank = rank
        self.device = device
        self.stage = bufs[rank].numel()
        self.barrier = barrier

    # ---------------------------------------------------------- set-up

    @classmethod
    def connect(cls, device, *, stage_bytes: int | None = None,
                require_same_card: bool = False):
        """Every rank of the default process group calls this, in one
        order. On a CUDA `device`: the buffers mapped through CUDA IPC
        when every rank holds the same card, else None (or, with
        `require_same_card`, a ``RuntimeError``). On the CPU: buffers in
        files under a temporary directory, mapped shared by every rank.
        The barrier table is such a file too; the files are unlinked
        once every rank has mapped them. `stage_bytes` defaults to
        ``STAGE_BYTES``."""
        device = torch.device(device)
        stage_bytes = int(stage_bytes or STAGE_BYTES)
        rank, world = dist.get_rank(), dist.get_world_size()
        if device.type == "cuda":
            bufs, device = cls._map_cuda(device, rank, world, stage_bytes,
                                         require_same_card)
            if bufs is None:
                return None
        here = [tempfile.mkdtemp(prefix="mesh-stage-") if rank == 0
                else None]
        dist.broadcast_object_list(here, src=0)
        root = here[0]
        barrier = HostBarrier.connect(root, rank, world)
        if device.type != "cuda":
            bufs = cls._map_files(root, rank, world, stage_bytes)
        dist.barrier()
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
        return cls(bufs, rank, device, barrier)

    @staticmethod
    def _map_cuda(device, rank, world, stage_bytes, require):
        from torch.multiprocessing.reductions import reduce_tensor
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        buf = torch.empty(stage_bytes, dtype=torch.uint8, device=device)
        uuid = str(torch.cuda.get_device_properties(device).uuid)
        # one share a receiving rank: each share is one IPC reference,
        # which that rank releases when it drops the buffer
        mine = (uuid, [None if r == rank else pickle.dumps(
            reduce_tensor(buf)) for r in range(world)])
        seen = [None] * world
        dist.all_gather_object(seen, mine)
        if len({u for u, _ in seen}) > 1:
            if require:
                raise RuntimeError(
                    "SharedBuffers: the ranks hold different cards; "
                    "shared staging needs every rank on one card")
            return None, device
        bufs = []
        for r, (_, blobs) in enumerate(seen):
            if r == rank:
                bufs.append(buf)
            else:
                rebuild, args = pickle.loads(blobs[rank])
                bufs.append(rebuild(*args))
        return bufs, device

    @staticmethod
    def _map_files(root, rank, world, stage_bytes):
        bufs = [None] * world
        bufs[rank] = torch.from_file(os.path.join(root, str(rank)),
                                     shared=True, size=stage_bytes,
                                     dtype=torch.uint8)
        dist.barrier()
        for r in range(world):
            if r != rank:
                bufs[r] = torch.from_file(os.path.join(root, str(r)),
                                          shared=True, size=stage_bytes,
                                          dtype=torch.uint8)
        return bufs

    def close(self, *, meet: bool = True) -> None:
        """Drop the other ranks' buffers (and, with `meet`, wait until
        every rank has, so no rank frees a buffer another still maps)."""
        self.bufs = [b if r == self.rank else None
                     for r, b in enumerate(self.bufs)]
        if meet:
            self._meet(range(len(self.bufs)))

    # ------------------------------------------------------- the steps

    def _meet(self, members) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.barrier.wait(members)

    def _rounds(self, src, members: list, read) -> None:
        """Stage `src` (rows, k) a block of columns at a time: each
        round copies this rank's block into its buffer, meets, hands
        ``read(a, b, parts)`` every member's staged (rows, b - a) block
        in group order, and meets again."""
        rows, k = src.shape
        size = src.dtype.itemsize
        step = max(1, self.stage // (size * rows))
        for a in range(0, k, step):
            b = min(k, a + step)
            n = rows * (b - a)
            self.bufs[self.rank][:n * size].view(src.dtype).view(
                rows, b - a).copy_(src[:, a:b])
            self._meet(members)
            read(a, b, [self.bufs[r][:n * size].view(src.dtype).view(
                rows, b - a) for r in members])
            self._meet(members)

    # --------------------------------------------------- the collectives

    @torch.no_grad()
    def all_gather(self, x, members: list):
        """(n * x.numel(),): every member's flat `x`, in group order."""
        src = x.contiguous().reshape(1, -1)
        out = src.new_empty((len(members), src.shape[1]))

        def read(a, b, parts):
            for j, p in enumerate(parts):
                out[j, a:b].copy_(p[0])
        self._rounds(src, members, read)
        return out.reshape(-1)

    @torch.no_grad()
    def all_reduce(self, x, members: list, op: str = "sum"):
        """The elementwise sum (or maximum) over the members of `x`, in
        group-rank order (a new contiguous tensor of x's shape)."""
        src = x.contiguous().reshape(1, -1)
        out = torch.empty_like(src[0])
        self._rounds(src, members, lambda a, b, parts: _reduce_into(
            out[a:b], [p[0] for p in parts], op))
        return out.view(x.shape)

    @torch.no_grad()
    def reduce_scatter(self, x, members: list):
        """Block i (of n equal blocks on dim 0) of the sum over the
        members of `x`, for member i (flat)."""
        src = x.contiguous().reshape(len(members), -1)
        i = members.index(self.rank)
        out = src.new_empty((src.shape[1],))
        self._rounds(src, members, lambda a, b, parts: _reduce_into(
            out[a:b], [p[i] for p in parts], "sum"))
        return out

    @torch.no_grad()
    def all_to_all(self, x, members: list):
        """Row block i of `x` (n equal blocks on dim 0) goes to member i;
        block j of the result came from member j (x's shape)."""
        src = x.contiguous().reshape(len(members), -1)
        i = members.index(self.rank)
        out = torch.empty_like(src)

        def read(a, b, parts):
            for j, p in enumerate(parts):
                out[j, a:b].copy_(p[i])
        self._rounds(src, members, read)
        return out.view(x.shape)


def _reduce_into(out, parts: list, op: str) -> None:
    out.copy_(parts[0])
    for p in parts[1:]:
        if op == "sum":
            out.add_(p)
        elif op == "max":
            torch.maximum(out, p, out=out)
        else:
            raise ValueError(f"op={op!r} (expected 'sum' or 'max')")


# ------------------------------------------------------- the rate probe

def _probe_rank(rank, n, mb):
    """Host ms of one all-gather, all-reduce and reduce-scatter of `mb`
    MB a rank and of a 16-byte all-reduce, shared buffers then the
    process group then shared again (in turns), each result's sum."""
    import time

    from repro_torch.launch.mesh import make_process_mesh
    shared = make_process_mesh(n, 1, device="cuda:0", transport="shared")
    group = make_process_mesh(n, 1, device="cuda:0", transport="group")
    gen = torch.Generator("cuda:0").manual_seed(rank)
    x = torch.randn(n, (mb << 20) // 4 // n, device="cuda:0", generator=gen)
    out = {}
    for name, m in (("shared", shared), ("group", group),
                    ("shared again", shared)):
        rec, sums = {}, []
        for op, fn in (("all_gather", m.all_gather),
                       ("all_reduce", m.all_reduce),
                       ("reduce_scatter", m.reduce_scatter)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(x, "data")
            torch.cuda.synchronize()
            rec[op] = (time.perf_counter() - t0) * 1e3
            sums.append(float(y.double().sum()))
        one = torch.ones(4, device="cuda:0")
        t0 = time.perf_counter()
        for _ in range(20):
            m.all_reduce(one, "data")
        torch.cuda.synchronize()
        rec["all_reduce 16 B"] = (time.perf_counter() - t0) * 1e3 / 20
        out[name] = {"ms": rec, "sums": sums}
    # the parts of a meet: a barrier through the host table alone, one
    # of the process group alone, a 16-byte copy and a stream
    # synchronisation alone
    t0 = time.perf_counter()
    for _ in range(20):
        shared.shared.barrier.wait(shared.members["data"])
    out["barrier_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    t0 = time.perf_counter()
    for _ in range(20):
        dist.barrier(group=shared.groups["data"])
    out["gloo_barrier_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    t0 = time.perf_counter()
    for _ in range(20):
        shared.shared.bufs[rank][:16].copy_(one.view(torch.uint8))
        torch.cuda.current_stream().synchronize()
    out["copy_sync_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    return out


def main(argv=None) -> int:
    """Ranks on cuda:0 (2, then 4): each collective's host ms through
    the shared buffers and through gloo, one JSON line a world."""
    import argparse
    import json

    from repro_torch.launch.mesh import spawn_local
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--mb", type=int, default=256,
                    help="MB a rank holds (the all-gather's input)")
    ap.add_argument("--ranks", default="2,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("transport probe: no CUDA device")
        return 1
    for n in map(int, args.ranks.split(",")):
        res = spawn_local(_probe_rank, n, backend="gloo",
                          args=(n, args.mb), wall_s=300.0)
        print(json.dumps({"ranks": n, "mb": args.mb, "card":
                          torch.cuda.get_device_name(0), "by_rank": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
