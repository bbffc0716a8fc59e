"""One-query decode attention against a contiguous (ring) KV cache or a
paged block pool — the wrappers around the CUDA kernels of
``csrc/decode_attn.cu`` (the ports of the TPU kernels
``repro/kernels/decode_attn.py:decode_attention`` and
``:decode_attention_paged``), plus their plain PyTorch versions
``decode_attention_ref`` and ``decode_attention_paged_ref``.

q: (B, H, hd); k/v: (B, S, KV, hd); kv_pos: (B, S) absolute positions
of the cache slots; kv_len/q_pos: (B,). Query head h reads KV head
h // (H / KV). Slots >= kv_len, positions > q_pos and, with
window > 0, positions <= q_pos - window are masked with the finite
``NEG_INF``. The paged form takes the global pool k/v (NB, blk, KV, hd)
and kv_pos (NB, blk) plus block_tables (B, nbs) int32: logical slot s
of row b lives at pool block ``block_tables[b, s // blk]``, offset
``s % blk``. A wrapper given CPU tensors computes the plain version;
given CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import LaunchCounts
from repro_torch.kernels.build import load

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# launches of the wrapper (bumped only where the kernel is launched)
LAUNCHES = LaunchCounts(decode_attention=0, decode_attention_paged=0)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_ref(q, k, v, kv_pos, kv_len, q_pos, *,
                         window: int = 0):
    """Plain version (mirrors models.layers.attention semantics)."""
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    groups = h // kv
    kk = k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(b, s, h, hd)
    vv = v[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(b, s, h, hd)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kk.float()) \
        / math.sqrt(hd)
    slot = torch.arange(s, device=q.device)[None, None, :]
    mask = (slot < kv_len[:, None, None]) \
        & (kv_pos[:, None, :] <= q_pos[:, None, None])
    if window:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, None, None] - window)
    scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                  device=q.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vv.float()).to(q.dtype)


def decode_attention_paged_ref(q, k, v, kv_pos, block_tables, kv_len,
                               q_pos, *, window: int = 0):
    """Plain paged version: gather each row's block chain from the pool,
    then run the contiguous plain version."""
    b = q.shape[0]
    blk, kv, hd = k.shape[1], k.shape[2], k.shape[3]
    nbs = block_tables.shape[1]
    tab = block_tables.long()
    gk = k[tab].reshape(b, nbs * blk, kv, hd)
    gv = v[tab].reshape(b, nbs * blk, kv, hd)
    gpos = kv_pos[tab].reshape(b, nbs * blk)
    return decode_attention_ref(q, gk, gv, gpos, kv_len, q_pos,
                                window=window)


@functools.cache
def _lib():
    """The loaded library with its C signatures declared, and the largest
    G * hd its kernels take (both read once)."""
    lib = load("decode_attn")
    lib.decode_attn_launch.restype = ctypes.c_int
    lib.decode_attn_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.decode_attn_paged_launch.restype = ctypes.c_int
    lib.decode_attn_paged_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.decode_attn_plan.restype = ctypes.c_int
    lib.decode_attn_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.decode_attn_max_group_width.restype = ctypes.c_int
    return lib, lib.decode_attn_max_group_width()


# the paths of csrc/decode_attn.cu (its Path enum)
PATHS = {"simt": 0, "mma": 1}


def _aligned(k, v) -> int:
    """1 when k and v are 16-byte aligned (the kernel's 16-byte copies)."""
    return int(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)


def kernel_path(q, k, v, block_tables=None) -> tuple[str, dict]:
    """The path a launch of ``csrc/decode_attn.cu`` takes on these (CUDA)
    operands, from the kernel's own plan: "mma" (bf16, k/v 16-byte
    aligned, hd a multiple of 16 up to 128, G = H/KV <= 8) or "simt";
    with the cluster size (CTAs a (row, KV head) group: the largest, up
    to 8, at which the card holds all B * KV clusters at once), the ring
    stages and a CTA's dynamic shared memory in bytes. ``block_tables``
    marks the paged layout (k/v the pool)."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    paged = block_tables is not None
    s = k.shape[1] * (block_tables.shape[1] if paged else 1)
    lib, _ = _lib()
    info = (ctypes.c_int * 3)()
    path = lib.decode_attn_plan(_DTYPES[q.dtype], int(paged), b, h, kvh, s,
                                hd, _aligned(k, v), info)
    if path < 0:
        raise ValueError(f"decode_attention: no plan for H={h} KV={kvh} "
                         f"hd={hd}")
    name = {v_: k_ for k_, v_ in PATHS.items()}[path]
    return name, dict(nsplit=info[0], stages=info[1], smem=info[2])


def _check(q, k, v, kv_pos, kv_len, q_pos):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: q (B, H, hd), k/v (B, S, KV, hd)")
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kvh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q/k/v must share float32 or "
                        "bfloat16")
    if tuple(kv_pos.shape) != (b, s) or tuple(kv_len.shape) != (b,) \
            or tuple(q_pos.shape) != (b,):
        raise ValueError("decode_attention: kv_pos (B, S), kv_len/q_pos (B,)")
    for t in (kv_pos, kv_len, q_pos):
        if t.dtype != torch.int32:
            raise TypeError("decode_attention: positions/lengths are int32")
    for t in (q, k, v, kv_pos, kv_len, q_pos):
        if t.device != q.device:
            raise ValueError("decode_attention: tensors on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError("decode_attention: inputs must be contiguous")


def decode_attention(q, k, v, kv_pos, kv_len, q_pos, *, window: int = 0):
    """(B, H, hd) flash-decoding output; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_pos, kv_len, q_pos,
                                    window=window)
    _check(q, k, v, kv_pos, kv_len, q_pos)
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    lib, max_width = _lib()
    if (h // kvh) * hd > max_width:
        raise ValueError(f"decode_attention: (H/KV)*hd = {(h // kvh) * hd} "
                         f"exceeds the kernel's {max_width}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attn_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_pos.data_ptr(), kv_len.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), b, h, kvh, s, hd, int(window),
        1.0 / math.sqrt(hd), _aligned(k, v), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed with "
                           f"error {rc}")
    LAUNCHES.bump("decode_attention")
    return out


def _check_paged(q, k, v, kv_pos, block_tables, kv_len, q_pos):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention_paged: q (B, H, hd), k/v "
                         "(NB, blk, KV, hd)")
    b, h, hd = q.shape
    nb, blk, kvh = k.shape[0], k.shape[1], k.shape[2]
    if k.shape[3] != hd or h % kvh:
        raise ValueError(f"decode_attention_paged: q {tuple(q.shape)} vs "
                         f"k {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention_paged: q/k/v must share float32 "
                        "or bfloat16")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("decode_attention_paged: block_tables (B, nbs)")
    if tuple(kv_pos.shape) != (nb, blk) or tuple(kv_len.shape) != (b,) \
            or tuple(q_pos.shape) != (b,):
        raise ValueError("decode_attention_paged: kv_pos (NB, blk), "
                         "kv_len/q_pos (B,)")
    for t in (kv_pos, block_tables, kv_len, q_pos):
        if t.dtype != torch.int32:
            raise TypeError("decode_attention_paged: tables, positions and "
                            "lengths are int32")
    for t in (q, k, v, kv_pos, block_tables, kv_len, q_pos):
        if t.device != q.device:
            raise ValueError("decode_attention_paged: tensors on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError("decode_attention_paged: inputs must be "
                             "contiguous")


def decode_attention_paged(q, k, v, kv_pos, block_tables, kv_len, q_pos, *,
                           window: int = 0):
    """(B, H, hd) flash-decoding output over the paged pool; CUDA tensors
    launch the kernel. Every table entry must name a pool block in
    [0, NB): the kernel reads a row's lanes below kv_len, and all nbs *
    blk of them for a row with no visible lane."""
    if q.device.type == "cpu":
        return decode_attention_paged_ref(q, k, v, kv_pos, block_tables,
                                          kv_len, q_pos, window=window)
    _check_paged(q, k, v, kv_pos, block_tables, kv_len, q_pos)
    b, h, hd = q.shape
    blk, kvh = k.shape[1], k.shape[2]
    nbs = block_tables.shape[1]
    lib, max_width = _lib()
    if (h // kvh) * hd > max_width:
        raise ValueError(f"decode_attention_paged: (H/KV)*hd = "
                         f"{(h // kvh) * hd} exceeds the kernel's "
                         f"{max_width}")
    if nbs * blk == 0:
        raise ValueError("decode_attention_paged: rows have no slots")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attn_paged_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_pos.data_ptr(), block_tables.data_ptr(), kv_len.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), b, h, kvh, blk, nbs, hd,
        int(window), 1.0 / math.sqrt(hd), _aligned(k, v), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_paged: CUDA launch failed "
                           f"with error {rc}")
    LAUNCHES.bump("decode_attention_paged")
    return out
