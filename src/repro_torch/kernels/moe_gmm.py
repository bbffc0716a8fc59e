"""Grouped expert matmuls of the MoE FFN over the capacity layout
x (E, C, D) — wrappers around the CUDA kernels of ``csrc/moe_gmm.cu``
and ``csrc/moe_gmm_q.cu`` (the port of the TPU kernels
``repro/kernels/moe_gmm.py:fused_gate_up``, ``:gmm``,
``:fused_gate_up_quant`` and ``:gmm_quant``), plus their plain PyTorch
versions.

  * ``fused_gate_up`` — silu(x @ Wg) * (x @ Wu): (E, C, D) -> (E, C, F)
  * ``gmm``           — x @ W: (E, C, D) -> (E, C, F)
  * ``fused_gate_up_quant`` / ``gmm_quant`` — the same over int8 weights
    (E, D, F) with float32 per-row scales (E, D) on the contraction axis
    (``kernels.quant`` layout), dequantized inside the kernel

Rows ``c >= group_sizes[e]`` are written as 0 and whole row tiles past
the group size are skipped. A wrapper given CPU tensors computes the
plain version; given CUDA tensors it launches its kernel or raises (as
it does for an input that requires grad under grad mode: no kernel has
a backward).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import LaunchCounts, ref, refuse_autograd
from repro_torch.kernels.build import load, num_sms

# launches per wrapper (bumped only where the kernel is launched)
LAUNCHES = LaunchCounts(fused_gate_up=0, gmm=0, fused_gate_up_quant=0,
                        gmm_quant=0)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_gate_up_ref(x, w_gate, w_up, group_sizes):
    """Plain version of ``fused_gate_up``."""
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    return ref._row_mask(h, group_sizes)


def gmm_ref(x, w, group_sizes):
    """Plain version of ``gmm``."""
    return ref.gmm_ref(x, w, group_sizes)


@functools.cache
def _lib():
    """The loaded library with its C signatures declared (once)."""
    lib = load("moe_gmm")
    lib.moe_gmm_workspace.restype = ctypes.c_longlong
    lib.moe_gmm_workspace.argtypes = [ctypes.c_int] * 9
    lib.moe_gmm_path.restype = ctypes.c_int
    lib.moe_gmm_path.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.moe_gmm_launch.restype = ctypes.c_int
    lib.moe_gmm_launch.argtypes = ([ctypes.c_int] * 2
                                   + [ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return lib


# the paths of csrc/moe_gmm.cu and csrc/moe_gmm_q.cu; a caller forces one
# only to measure it against the other
PATHS = {"simt": 0, "wgmma": 1}
# moe_gmm_launch's code for a tensor map cuTensorMapEncodeTiled refused
_ENCODE_ERROR = 100000


def _plan_args(x, ws, out):
    """(aligned, number of SMs): what the kernel's launch plan reads
    besides the shapes (16-byte alignment allows the vector loads and
    the TMA tensor maps)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *ws, out))
    sms = num_sms(x.device)
    return int(aligned), sms


def kernel_path(x, w, fused: bool = False) -> tuple[str, dict]:
    """The path of a launch of ``csrc/moe_gmm.cu`` on these (CUDA)
    operands, from the kernel's own plan: "wgmma" (bf16, D and F
    multiples of 8, 16-byte aligned) or "simt"; with the wgmma CTA's
    rows (N), ring stages and dynamic shared memory in bytes (zeros on
    the simt path)."""
    e, c, d = x.shape
    out = torch.empty(0, dtype=x.dtype, device=x.device)
    aligned, sms = _plan_args(x, (w,), out)
    info = (ctypes.c_int * 3)()
    path = _lib().moe_gmm_path(int(fused), _DTYPES[x.dtype], e, c, d,
                               w.shape[2], aligned, sms, info)
    name = {v: k for k, v in PATHS.items()}[path]
    return name, dict(rows=info[0], stages=info[1], smem=info[2])


def _check(name, x, ws, group_sizes):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (E, C, D), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} (float32 or bfloat16)")
    e, _, d = x.shape
    for w in ws:
        if w.dim() != 3 or w.shape[0] != e or w.shape[1] != d:
            raise ValueError(f"{name}: weight {tuple(w.shape)} does not "
                             f"match x {tuple(x.shape)}")
        if w.shape[2] != ws[0].shape[2]:
            raise ValueError(f"{name}: weights differ in width")
    if tuple(group_sizes.shape) != (e,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"{name}: group_sizes must be int32 (E,)")
    for t in (x, *ws, group_sizes):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for w in ws:
        if w.dtype != x.dtype:
            raise TypeError(f"{name}: weight dtype {w.dtype} != {x.dtype}")


def _launch(name, fused, x, wg, wu, group_sizes, path=None):
    """Launch the kernel; `path` (a key of PATHS) forces a path, else the
    kernel's plan picks it."""
    ws = (wg, wu) if fused else (wg,)
    refuse_autograd(name, x, *ws)
    _check(name, x, ws, group_sizes)
    e, c, d = x.shape
    f = wg.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    aligned, sms = _plan_args(x, ws, out)
    dt = _DTYPES[x.dtype]
    forced = -1 if path is None else PATHS[path]
    work = torch.empty((lib.moe_gmm_workspace(int(fused), dt, e, c, d, f,
                                              aligned, sms, forced),),
                       dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.moe_gmm_launch(int(fused), dt, x.data_ptr(), wg.data_ptr(),
                            (wu if fused else wg).data_ptr(),
                            group_sizes.data_ptr(), out.data_ptr(),
                            work.data_ptr(), e, c, d, f, aligned, sms,
                            forced, stream)
    if rc >= _ENCODE_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a TMA "
                           f"tensor map (CUresult {rc - _ENCODE_ERROR})")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES.bump(name)
    return out


def fused_gate_up(x, w_gate, w_up, group_sizes):
    """(E, C, D) -> (E, C, F): silu(x @ Wg) * (x @ Wu), rows past
    ``group_sizes[e]`` zero. CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_gate_up_ref(x, w_gate, w_up, group_sizes)
    return _launch("fused_gate_up", True, x, w_gate, w_up, group_sizes)


def gmm(x, w, group_sizes):
    """(E, C, D) x (E, D, F) -> (E, C, F), rows past ``group_sizes[e]``
    zero. CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes)
    return _launch("gmm", False, x, w, None, group_sizes)


# ------------------------------------------------- int8 weights (csrc/moe_gmm_q.cu)


def fused_gate_up_quant_ref(x, wg_q, wg_s, wu_q, wu_s, group_sizes):
    """Plain version of ``fused_gate_up_quant``: float32 products over
    the dequantized weights of each expert with rows (one expert at a
    time), output in x's dtype."""
    e, c, _ = x.shape
    out = torch.zeros((e, c, wg_q.shape[2]), dtype=x.dtype, device=x.device)
    for i in ref._active_slots(group_sizes, e):
        g = ref._rows(group_sizes, i, c)
        xe = x[i, :g].float()
        out[i, :g] = (F.silu(xe @ ref._deq(wg_q[i], wg_s[i]))
                      * (xe @ ref._deq(wu_q[i], wu_s[i]))).to(x.dtype)
    return out


def gmm_quant_ref(x, wq, scale, group_sizes):
    """Plain version of ``gmm_quant``, output in x's dtype."""
    return ref.gmm_ref_quant(x, wq, scale, group_sizes).to(x.dtype)


@functools.cache
def _qlib():
    """The loaded int8 library with its C signatures declared (once)."""
    lib = load("moe_gmm_q")
    lib.moe_gmm_q_plan.restype = ctypes.c_int
    lib.moe_gmm_q_plan.argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.moe_gmm_q_launch.restype = ctypes.c_int
    lib.moe_gmm_q_launch.argtypes = ([ctypes.c_int] * 2
                                     + [ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
    return lib


# launches of each int8 kernel by the path they took (bumped where
# LAUNCHES is): a run shows which path served it
QUANT_PATH_LAUNCHES = {n: LaunchCounts({p: 0 for p in PATHS})
                       for n in ("fused_gate_up_quant", "gmm_quant")}
_PATH_NAMES = {v: k for k, v in PATHS.items()}


def _check_quant(name, x, qs, group_sizes):
    """x (E, C, D) float32/bfloat16; qs: (int8 (E, D, F), float32 (E, D))
    pairs; group_sizes int32 (E,); all contiguous on x's device."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (E, C, D), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} (float32 or bfloat16)")
    e, _, d = x.shape
    for w, s in qs:
        if w.dtype != torch.int8 or s.dtype != torch.float32:
            raise TypeError(f"{name}: weights must be int8 with float32 "
                            f"scales, got {w.dtype} / {s.dtype}")
        if w.dim() != 3 or w.shape[0] != e or w.shape[1] != d:
            raise ValueError(f"{name}: weight {tuple(w.shape)} does not "
                             f"match x {tuple(x.shape)}")
        if tuple(s.shape) != (e, d):
            raise ValueError(f"{name}: scales {tuple(s.shape)} != {(e, d)}")
        if w.shape[2] != qs[0][0].shape[2]:
            raise ValueError(f"{name}: weights differ in width")
    if tuple(group_sizes.shape) != (e,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"{name}: group_sizes must be int32 (E,)")
    for t in (x, *(a for pair in qs for a in pair), group_sizes):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _qplan(fused, x, tensors, f, max_active, path=None):
    """The plan of a launch of ``csrc/moe_gmm_q.cu``: (path taken, the
    info of ``moe_gmm_q_plan``, aligned, number of SMs). `tensors` are
    the int8 weights and their scales; the output, fresh from the caching
    allocator, is aligned; `path` (a key of PATHS) forces a path."""
    e, c, d = x.shape
    aligned = int(all(t.data_ptr() % 16 == 0 for t in (x, *tensors)))
    sms = num_sms(x.device)
    info = (ctypes.c_longlong * 5)()
    code = _qlib().moe_gmm_q_plan(int(fused), _DTYPES[x.dtype], e, c, d, f,
                                  aligned, sms, max_active,
                                  -1 if path is None else PATHS[path], info)
    return _PATH_NAMES[code], list(info), aligned, sms


def quant_plan(x, wq, max_active: int = 0, scale=None) -> tuple[str, dict]:
    """The path of a launch of ``csrc/moe_gmm_q.cu`` on these (CUDA)
    operands, from the kernel's own plan: "wgmma" (bf16 x, D a multiple
    of 8, F of 16, 16-byte aligned x, weights and scales) or "simt"; with
    the simt path's D splits (1 on wgmma) and the wgmma CTA's rows (N),
    ring stages and dynamic shared memory in bytes (zeros on simt).
    `scale` (the weight's (E, D) scales) joins the alignment check."""
    tensors = (wq,) if scale is None else (wq, scale)
    path, info, _, _ = _qplan(False, x, tensors, wq.shape[2], max_active)
    return path, dict(ksplit=info[0], rows=info[1], stages=info[2],
                      smem=info[3])


def _launch_quant(name, fused, x, qs, group_sizes, max_active, path=None):
    """Launch the int8 kernel; `path` (a key of PATHS) forces a path,
    else the kernel's plan picks it."""
    refuse_autograd(name, x, *[t for pair in qs for t in pair])
    _check_quant(name, x, qs, group_sizes)
    e, c, d = x.shape
    f = qs[0][0].shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    (wg, sg), (wu, su) = qs[0], qs[-1]
    taken, info, aligned, sms = _qplan(fused, x, (wg, sg, wu, su), f,
                                       max_active, path)
    work = torch.empty((info[4],), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _qlib().moe_gmm_q_launch(
        int(fused), _DTYPES[x.dtype], x.data_ptr(), wg.data_ptr(),
        sg.data_ptr(), wu.data_ptr(), su.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), work.data_ptr(), e, c, d, f, aligned, sms,
        max_active, -1 if path is None else PATHS[path], stream)
    if rc >= _ENCODE_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a TMA "
                           f"tensor map (CUresult {rc - _ENCODE_ERROR})")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES.bump(name)
    QUANT_PATH_LAUNCHES[name].bump(taken)
    return out


def fused_gate_up_quant(x, wg_q, wg_s, wu_q, wu_s, group_sizes,
                        max_active: int = 0):
    """(E, C, D) -> (E, C, F): silu(x @ deq(Wg)) * (x @ deq(Wu)) over
    int8 weights with float32 per-row scales, rows past
    ``group_sizes[e]`` zero, output in x's dtype. `max_active` (0:
    unknown) bounds how many experts have rows; it sizes the kernel's
    split of D. CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_gate_up_quant_ref(x, wg_q, wg_s, wu_q, wu_s,
                                       group_sizes)
    return _launch_quant("fused_gate_up_quant", True, x,
                         [(wg_q, wg_s), (wu_q, wu_s)], group_sizes,
                         max_active)


def gmm_quant(x, wq, scale, group_sizes, max_active: int = 0):
    """(E, C, D) x int8 (E, D, F) with float32 per-row scales (E, D) ->
    (E, C, F), rows past ``group_sizes[e]`` zero, output in x's dtype.
    `max_active` as in ``fused_gate_up_quant``. CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return gmm_quant_ref(x, wq, scale, group_sizes)
    return _launch_quant("gmm_quant", False, x, [(wq, scale)], group_sizes,
                         max_active)
