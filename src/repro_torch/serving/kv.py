"""Slot-based batched KV management for continuous batching.

``SlotKVCache`` (contiguous) — each slot owns a contiguous row of every
layer's attention ring buffer. A request is prefilled alone (B=1) into a
private cache, then its cache row is spliced into the pool at its slot.
The paged pool with prefix sharing arrives with a later slice of the
port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as T


def _splice(pool_leaf, row_leaf, slot: int) -> None:
    # pool leaf: (periods, num_slots, ...); row leaf: (periods, 1, ...).
    # Written in place (the reference returns an updated copy).
    pool_leaf[:, slot] = row_leaf[:, 0].to(pool_leaf.dtype)


def _splice_tree(pool, row, slot: int) -> None:
    if isinstance(pool, dict):
        for k in pool:
            _splice_tree(pool[k], row[k], slot)
    elif isinstance(pool, list):
        for p, r in zip(pool, row):
            _splice_tree(p, r, slot)
    else:
        _splice(pool, row, slot)


class SlotKVCache:
    """Fixed pool of `num_slots` KV slots with a free list.

    Attributes:
      cache    — the batched cache tree consumed by ``T.decode_step``
                 (leaves stacked (periods, num_slots, ...)).
      lengths  — host (num_slots,) int32 per-slot cache depths.
      active   — host (num_slots,) bool; inactive slots still flow
                 through the batched step but their outputs are ignored
                 and their lengths frozen.
      owners   — host (num_slots,) int64 request id occupying each slot
                 (-1 when free).
    """

    def __init__(self, cfg, params, num_slots: int, max_len: int,
                 batch_multiple: int = 1):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        # pool rows padded to a batch multiple; pad rows are never
        # allocated and flow through the batched step as masked no-ops
        self.rows = -(-num_slots // batch_multiple) * batch_multiple
        self.cache = T.init_cache(cfg, params, self.rows, max_len)
        self.device = params["embed"].device
        self.lengths = np.zeros(self.rows, np.int32)
        self.active = np.zeros(self.rows, bool)
        self.owners = np.full(self.rows, -1, np.int64)
        self._free = list(range(num_slots - 1, -1, -1))

    # ------------------------------------------------------------ slots

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV slot pool exhausted")
        return self._free.pop()

    def free(self, slot: int) -> None:
        if self.active[slot] or slot in self._free:
            raise ValueError(f"freeing slot {slot} in invalid state")
        self.lengths[slot] = 0
        self.owners[slot] = -1
        self._free.append(slot)

    def _check_insertable(self, slot: int) -> None:
        """Reject binding data to a slot that was never ``alloc``'d (it
        is still on the free list) or that is already holding a live
        request (double insert) — both would silently corrupt another
        request's cache row."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.num_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} was never alloc'd "
                             "(still on the free list)")
        if self.active[slot]:
            raise ValueError(f"double insert into active slot {slot} "
                             f"(owner {self.owners[slot]})")

    # ------------------------------------------------------------ data

    def insert(self, slot: int, request_cache, length: int,
               owner: int = -1) -> None:
        """Splice a single-request (B=1) prefilled cache into `slot`."""
        if not 0 <= length <= self.max_len:
            raise ValueError(f"length {length} outside [0, {self.max_len}]")
        self._check_insertable(slot)
        _splice_tree(self.cache, request_cache, slot)
        self.lengths[slot] = length
        self.active[slot] = True
        self.owners[slot] = owner

    def release(self, slot: int) -> int:
        """Mark a finished request's slot inactive and recycle it."""
        self.active[slot] = False
        self.free(slot)
        return slot

    def step_lengths(self):
        """(lengths, active) as device tensors for the batched decode
        step: per-row cache_len plus the mask of rows whose outputs
        matter."""
        return (torch.from_numpy(self.lengths.copy()).to(self.device),
                torch.from_numpy(self.active.copy()).to(self.device))

    def advance(self, counts=None) -> list[int]:
        """Account this iteration's written tokens (`counts` per row;
        None = the classic one-token decode for every active slot).
        Lengths saturate at ``max_len`` — the ring must not wrap and
        overwrite the oldest KV — and the slots that hit the cap are
        returned so the engine can finish them with
        ``finish_reason="length"`` instead of corrupting their cache."""
        if counts is None:
            counts = self.active.astype(np.int32)
        new = np.where(self.active,
                       self.lengths + np.asarray(counts, np.int32),
                       self.lengths)
        capped = np.flatnonzero(self.active & (new >= self.max_len))
        self.lengths = np.minimum(new, self.max_len).astype(np.int32)
        return [int(s) for s in capped]
