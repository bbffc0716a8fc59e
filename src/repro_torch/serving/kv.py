"""Slot-based batched KV management for continuous batching.

Two pool layouts behind ONE slot/free-list/owner API
(``cfg.serving.kv`` selects):

``SlotKVCache`` (contiguous) — each slot owns a contiguous row of every
layer's attention ring buffer. A request is prefilled alone (B=1) into a
private cache, then its cache row is spliced into the pool at its slot.

``PagedKVCache`` (paged) — a global pool of fixed-size KV blocks
(``cfg.serving.kv_block`` tokens each) shared by every attention layer:
block b of every (k, v, pos) leaf belongs to the same logical block, so
ONE host-side allocator (refcounts + free list) manages the whole tree.
Each slot holds a host block *table* mapping position ``p`` to pool
block ``table[p // block]``; the batched step scatters new tokens
through the table and reads each row's chain from it. Blocks are
refcounted so a ``RadixPrefixCache`` can share prompt-prefix chains
across requests; a shared block is copied before its first divergent
write (copy-on-write), and cache-only chains are LRU-evicted under pool
pressure. Block 0 is a reserved trash target: rows with no new tokens
this step (inactive, or mid-prefill rows past their chunk) write there.

Greedy tokens are bitwise equal to the contiguous layout's for any
block size (tested): every lane past a row's length scores the same
exact ``NEG_INF`` as in the contiguous ring and contributes exact 0.0,
and each query's computation is independent of the other rows.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.models import transformer as T


def _splice(pool_leaf, row_leaf, slot: int) -> None:
    # pool leaf: (periods, num_slots, ...); row leaf: (periods, 1, ...).
    # Written in place (the reference returns an updated copy).
    pool_leaf[:, slot] = row_leaf[:, 0].to(pool_leaf.dtype)


def _splice_tree(pool, row, slot: int) -> None:
    # every leaf of the row, recurrent (SSM) state included: a slot's
    # previous occupant leaves nothing behind
    if isinstance(pool, dict):
        for k in pool:
            _splice_tree(pool[k], row[k], slot)
    elif isinstance(pool, (list, tuple)):
        for p, r in zip(pool, row):
            _splice_tree(p, r, slot)
    else:
        _splice(pool, row, slot)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


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


# ---------------------------------------------------------------- paged


def _splice_blocks(pool_leaf, row_leaf, blocks, block: int) -> None:
    """Scatter one dense cache row into pool blocks, in place.

    pool leaf: (periods, NB, block, ...); row leaf: (periods, 1, smax,
    ...); blocks: (nbs,) pool block ids with nbs*block >= smax."""
    np_, _, smax = row_leaf.shape[:3]
    nbs = blocks.shape[0]
    r = row_leaf[:, 0]
    pad = nbs * block - smax
    if pad:
        r = torch.cat([r, r.new_zeros((np_, pad) + tuple(r.shape[2:]))],
                      dim=1)
    r = r.reshape((np_, nbs, block) + tuple(r.shape[2:]))
    pool_leaf[:, blocks] = r.to(pool_leaf.dtype)


def _splice_blocks_tree(pool, row, blocks, block: int) -> None:
    if isinstance(pool, dict):
        for k in pool:
            _splice_blocks_tree(pool[k], row[k], blocks, block)
    elif isinstance(pool, list):
        for p, r in zip(pool, row):
            _splice_blocks_tree(p, r, blocks, block)
    else:
        _splice_blocks(pool, row, blocks, block)


def _copy_blocks(pool, src: list[int], dst: list[int]) -> None:
    """Copy-on-write on the device: pool[:, dst] = pool[:, src] on every
    leaf, in place."""
    for leaf in _tree_leaves(pool):
        s = torch.as_tensor(src, dtype=torch.long, device=leaf.device)
        d = torch.as_tensor(dst, dtype=torch.long, device=leaf.device)
        leaf[:, d] = leaf[:, s]


class _RadixNode:
    """One cached block: up to block-size tokens of some prompt chain.
    ``block`` is the POOL BLOCK ID the node owns a cache refcount on.
    Children are keyed by their token tuple; a node is a *partial* block
    when it holds fewer than block-size tokens (always a chain tail)."""

    __slots__ = ("tokens", "block", "parent", "children", "last_used")

    def __init__(self, tokens: tuple, block_id: int, parent):
        self.tokens = tokens
        self.block = block_id
        self.parent = parent
        self.children: dict[tuple, _RadixNode] = {}
        self.last_used = 0


class RadixPrefixCache:
    """Radix (block-granular trie) cache of prompt-prefix block chains.

    Each node owns one pool block (the cache holds a refcount on it);
    matching an incoming prompt walks full-block children first, then at
    most one partial tail whose tokens prefix the remainder. Insertion
    happens on request release and dedupes against existing nodes.
    Eviction is LRU over *leaf* nodes whose block is referenced by the
    cache alone (refcount 1) — freeing a leaf may expose its parent, so
    whole cold chains unwind back to front."""

    def __init__(self, pool: "PagedKVCache"):
        self.pool = pool
        self.block = pool.block
        self.root = _RadixNode((), 0, None)
        self._clock = 0
        self.hits = 0
        self.tokens_saved = 0

    def _touch(self, node: _RadixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def match(self, prompt) -> tuple[int, list[int]]:
        """Longest cached prefix of `prompt`: (matched_tokens,
        [block ids]) — full blocks plus at most one partial tail."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        node, i, chain = self.root, 0, []
        while i + self.block <= len(prompt):
            child = node.children.get(tuple(prompt[i:i + self.block]))
            if child is None:
                break
            node, i = child, i + self.block
            chain.append(child.block)
            self._touch(child)
        # partial tail: the longest partial child prefixing the rest
        rest = tuple(prompt[i:])
        best = None
        for child in node.children.values():
            if len(child.tokens) < self.block \
                    and rest[:len(child.tokens)] == child.tokens \
                    and (best is None
                         or len(child.tokens) > len(best.tokens)):
                best = child
        if best is not None:
            i += len(best.tokens)
            chain.append(best.block)
            self._touch(best)
        return i, chain

    def insert(self, tokens, blocks) -> None:
        """Cache the chain covering `tokens` (block-aligned walk of
        `blocks`). Existing nodes win (the releasing request's duplicate
        block is simply decref'd by the caller); new nodes take a cache
        refcount on their block."""
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        node, i = self.root, 0
        for b in blocks:
            chunk = tuple(tokens[i:i + self.block])
            if not chunk:
                break
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(chunk, int(b), node)
                node.children[chunk] = child
                self.pool._incref(int(b))
                self._touch(child)
            if len(chunk) < self.block:
                break
            node, i = child, i + self.block

    def evictable(self, exclude=()) -> int:
        """Blocks that ``evict`` could free, now or after peeling their
        descendants: a node is evictable iff it is cache-only
        (refcount 1), its block is not in `exclude` (blocks a pending
        admission intends to share/pin), and its entire subtree is too."""
        exclude = frozenset(int(b) for b in exclude)

        def count(n: _RadixNode) -> tuple[bool, int]:
            all_ok = (self.pool.refcount[n.block] == 1
                      and n.block not in exclude)
            total = 0
            for c in n.children.values():
                ok, t = count(c)
                total += t
                all_ok = all_ok and ok
            return all_ok, total + (1 if all_ok else 0)
        return sum(count(c)[1] for c in self.root.children.values())

    def evict(self, need: int) -> int:
        """LRU-evict cache-only leaf chains until `need` blocks were
        freed (or nothing evictable remains). Returns blocks freed.

        One trie walk seeds a min-heap of evictable leaves keyed by
        ``last_used``; freeing a leaf may expose its parent, which is
        pushed as it becomes a childless cache-only node — evicting k
        blocks is O(n + k log n)."""
        freed = 0
        heap = [(n.last_used, id(n), n) for n in self._walk()
                if not n.children
                and self.pool.refcount[n.block] == 1]
        heapq.heapify(heap)
        while freed < need and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.tokens]
            self.pool._decref(victim.block)
            freed += 1
            if (parent is not self.root and not parent.children
                    and self.pool.refcount[parent.block] == 1):
                heapq.heappush(
                    heap, (parent.last_used, id(parent), parent))
        return freed

    def _walk(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())


class PagedKVCache:
    """Block/paged KV pool with per-slot block tables, refcounted
    shared-prefix blocks, and copy-on-write — the same slot/free-list/
    owner API as ``SlotKVCache`` so the engine and scheduler drive
    either.

    Layout: each attention leaf is ``(periods, num_blocks, block, ...)``
    and pool block ``b`` addresses the b-th block of EVERY leaf, so one
    host allocator covers the whole cache tree. Host state:

      tables    — (rows, blocks_per_slot) int32; ``tables[s, i]`` holds
                  positions ``[i*block, (i+1)*block)`` of slot s.
                  Unassigned entries are 0 = the reserved trash block.
      refcount  — (num_blocks,) int; a block is freed at refcount 0.
                  Holders: each slot table referencing it, plus the
                  radix prefix cache (one ref per cached node).

    Admission reserves the FULL block budget for ``prompt + max_new``
    up front (minus refcount-shared full prefix blocks), so decode can
    never exhaust the pool mid-flight — under pressure the scheduler
    holds/rejects at admission instead (``admission_error`` /
    ``can_admit``). Copy-on-write has exactly one trigger: a shared
    prefix whose match ends inside a block — that boundary block is
    copied into the reservation before the first divergent write,
    leaving the cached chain intact."""

    def __init__(self, cfg, params, num_slots: int, max_len: int, *,
                 block: int = 16, num_blocks: int = 0,
                 batch_multiple: int = 1, prefix_cache: bool = False,
                 chunked: bool = False):
        if block < 1:
            raise ValueError(f"kv_block={block} must be >= 1")
        T.require_paged_kv(cfg)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.block = block
        self.blocks_per_slot = -(-max_len // block)
        # block 0 is the permanently allocated trash target for masked
        # writes; the default pool backs every slot fully so the paged
        # engine can always admit whatever the contiguous one could
        self.num_blocks = num_blocks or 1 + num_slots * self.blocks_per_slot
        self.rows = -(-num_slots // batch_multiple) * batch_multiple
        self.cache = T.init_paged_cache(cfg, params, self.num_blocks, block)
        self.device = params["embed"].device
        self.lengths = np.zeros(self.rows, np.int32)
        self.active = np.zeros(self.rows, bool)
        self.owners = np.full(self.rows, -1, np.int64)
        self.tables = np.zeros((self.rows, self.blocks_per_slot), np.int32)
        self.nblocks = np.zeros(self.rows, np.int32)
        self.refcount = np.zeros(self.num_blocks, np.int64)
        self.refcount[0] = 1                       # trash never freed
        self._free = list(range(num_slots - 1, -1, -1))
        self._free_blocks = list(range(self.num_blocks - 1, 0, -1))
        self._slot_tokens: dict[int, np.ndarray] = {}
        self.prefix = RadixPrefixCache(self) if prefix_cache else None
        self.cow_blocks = 0            # blocks copied by copy-on-write
        # chunked admission reserves the request's exact
        # ``prompt + max_new`` footprint via ``begin``; the solo-prefill
        # path (``insert``) splices a full dense row, so each admission
        # costs the whole ``blocks_per_slot``
        self.chunked = chunked

    # ------------------------------------------------------------ slots
    # (the same surface as SlotKVCache)

    num_free = SlotKVCache.num_free
    num_active = SlotKVCache.num_active
    alloc = SlotKVCache.alloc
    free = SlotKVCache.free
    _check_insertable = SlotKVCache._check_insertable

    # ----------------------------------------------------------- blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - 1 - len(self._free_blocks)

    @property
    def block_bytes(self) -> int:
        """Bytes ONE pool block occupies across every cache leaf (all
        layers' k + v + pos) — cross-checked against the analytic
        ``core.costmodel.kv_bytes_per_block``."""
        return sum(leaf.numel() * leaf.element_size() // leaf.shape[1]
                   for leaf in _tree_leaves(self.cache))

    @property
    def pool_bytes(self) -> int:
        return self.block_bytes * self.num_blocks

    def _incref(self, b: int) -> None:
        self.refcount[b] += 1

    def _decref(self, b: int) -> None:
        self.refcount[b] -= 1
        if self.refcount[b] < 0:
            raise AssertionError(f"block {b} refcount went negative")
        if self.refcount[b] == 0:
            self._free_blocks.append(b)

    def _alloc_block(self) -> int:
        b = self._free_blocks.pop()
        self.refcount[b] = 1
        return b

    def blocks_needed(self, prompt_len: int, max_new: int,
                      shared_full: int = 0) -> int:
        """Fresh blocks an admission must reserve: the request's whole
        ``prompt + max_new`` footprint minus fully shared prefix blocks
        (a shared partial boundary block still costs its own copy)."""
        total = -(-(prompt_len + max_new) // self.block)
        return max(total - shared_full, 0)

    def admission_error(self, prompt_len: int, max_new: int) -> str:
        """Non-empty reason string when a request can NEVER be admitted
        (its cold-path block footprint exceeds the whole pool)."""
        need = self.blocks_needed(prompt_len, max_new) if self.chunked \
            else self.blocks_per_slot
        usable = self.num_blocks - 1
        if need > usable:
            return (f"needs {prompt_len + max_new} KV tokens = {need} "
                    f"blocks of {self.block}, pool holds {usable}")
        return ""

    def can_admit(self, prompt_len: int, max_new: int, prompt=None) \
            -> bool:
        """Whether the pool can reserve this request's blocks right now
        (free + prefix-evictable, minus whatever the prefix cache would
        share for `prompt`)."""
        if not self.chunked:   # solo splice reserves the whole slot
            return self.blocks_per_slot <= len(self._free_blocks)
        shared_full, pinned = 0, ()
        if self.prefix is not None and prompt is not None:
            matched, chain = self.prefix.match(prompt)
            hit = min(matched, prompt_len - 1)
            shared_full = hit // self.block
            # the blocks `begin` will pin (shared full blocks + the COW
            # source boundary block) are not evictable headroom: `need`
            # already assumes they survive
            n_pin = shared_full + (1 if hit > shared_full * self.block
                                   else 0)
            pinned = chain[:n_pin]
        need = self.blocks_needed(prompt_len, max_new, shared_full)
        avail = len(self._free_blocks)
        if self.prefix is not None and need > avail:
            avail += self.prefix.evictable(exclude=pinned)
        return need <= avail

    def _ensure_free(self, need: int) -> None:
        if need > len(self._free_blocks) and self.prefix is not None:
            self.prefix.evict(need - len(self._free_blocks))
        if need > len(self._free_blocks):
            raise RuntimeError(
                f"KV block pool exhausted: need {need} blocks, "
                f"{len(self._free_blocks)} free "
                f"(admission should have held this request)")

    # ------------------------------------------------------------ data

    def begin(self, slot: int, prompt, max_new: int,
              owner: int = -1) -> int:
        """Open `slot` for chunked prefill of `prompt`: match the prefix
        cache, share its full blocks, copy-on-write the boundary block
        if the match ends inside one, and reserve every remaining block
        of the ``prompt + max_new`` footprint. The slot starts at
        ``lengths = hit`` — the engine prefills only ``[hit, plen)``.
        Returns the prefix hit length (capped at ``plen - 1`` so the
        last prompt position is always recomputed for first-token
        logits)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        if not 0 < plen <= self.max_len:
            raise ValueError(f"prompt length {plen} outside "
                             f"(0, {self.max_len}]")
        self._check_insertable(slot)
        hit, chain = 0, []
        if self.prefix is not None:
            matched, chain = self.prefix.match(prompt)
            hit = min(matched, plen - 1)
        n_keep = hit // self.block         # fully shared, read-only
        total = -(-(plen + max_new) // self.block)
        fresh_n = total - n_keep
        # Pin the matched chain BEFORE eviction can run: the shared full
        # blocks and the COW-source boundary block may be cache-only
        # (refcount 1), and `_ensure_free` -> `evict` would otherwise
        # free them and `_alloc_block` could hand the same pool block
        # back as one of this request's fresh write targets — one block
        # at two table indices, so decode writes would corrupt the
        # shared prefix this row reads.
        cow_src = chain[n_keep] if hit > n_keep * self.block else None
        pinned = list(chain[:n_keep])
        if cow_src is not None:
            pinned.append(cow_src)
        for b in pinned:
            self._incref(b)
        try:
            self._ensure_free(fresh_n)
        except BaseException:
            for b in pinned:
                self._decref(b)
            raise
        fresh = [self._alloc_block() for _ in range(fresh_n)]
        row = np.zeros(self.blocks_per_slot, np.int32)
        # the pin on chain[:n_keep] becomes the table's refcount
        row[:n_keep] = chain[:n_keep]
        row[n_keep:total] = fresh
        if cow_src is not None:
            # the match ends inside chain[n_keep]: the tail prefill
            # writes into that block from position `hit`, so copy it
            # into the reservation first (the cached chain keeps its
            # block untouched), then drop its pin
            _copy_blocks(self.cache, [cow_src], [int(fresh[0])])
            self.cow_blocks += 1
            self._decref(cow_src)
        self.tables[slot] = row
        self.nblocks[slot] = total
        self.lengths[slot] = hit
        self.active[slot] = True
        self.owners[slot] = owner
        self._slot_tokens[slot] = prompt
        if self.prefix is not None:
            self.prefix.hits += hit > 0
            self.prefix.tokens_saved += hit
        return hit

    def insert(self, slot: int, request_cache, length: int,
               owner: int = -1) -> None:
        """Splice a solo-prefilled (B=1, contiguous) cache into `slot`'s
        blocks — the path that lets the paged pool serve the solo-prefill
        engine loop (no sharing: the slot reserves its full
        ``blocks_per_slot`` footprint)."""
        if not 0 <= length <= self.max_len:
            raise ValueError(f"length {length} outside [0, {self.max_len}]")
        self._check_insertable(slot)
        total = self.blocks_per_slot
        self._ensure_free(total)
        fresh = [self._alloc_block() for _ in range(total)]
        self.tables[slot] = fresh
        self.nblocks[slot] = total
        _splice_blocks_tree(self.cache, request_cache,
                            torch.as_tensor(fresh, dtype=torch.long,
                                            device=self.device),
                            self.block)
        self.lengths[slot] = length
        self.active[slot] = True
        self.owners[slot] = owner

    def release(self, slot: int) -> int:
        """Return a finished request's blocks: prompt-prefix blocks that
        hold fully written tokens are offered to the radix cache first
        (which takes its own refcount), then every table entry is
        decref'd and the slot recycled."""
        if self.prefix is not None and slot in self._slot_tokens:
            prompt = self._slot_tokens[slot]
            covered = int(min(self.lengths[slot], prompt.shape[0]))
            nb = -(-covered // self.block) if covered else 0
            if nb:
                self.prefix.insert(prompt[:covered],
                                   [int(b) for b in
                                    self.tables[slot, :nb]])
        for b in self.tables[slot, :int(self.nblocks[slot])]:
            self._decref(int(b))
        self.tables[slot] = 0
        self.nblocks[slot] = 0
        self._slot_tokens.pop(slot, None)
        self.active[slot] = False
        self.free(slot)
        return slot

    def step_state(self):
        """(lengths, active, tables) as device tensors for the batched
        step: per-row cache_len, the output mask, and the block tables
        the paged attention scatters and reads through."""
        lengths, active = self.step_lengths()
        return lengths, active, \
            torch.from_numpy(self.tables.copy()).to(self.device)

    step_lengths = SlotKVCache.step_lengths
    advance = SlotKVCache.advance
