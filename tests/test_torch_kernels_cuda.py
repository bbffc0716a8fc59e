"""PyTorch port, on the card: the hand-written CUDA kernels against their
plain PyTorch versions at the adversarial shapes (non-tile-aligned
C/D/F, all-zero and partial group sizes, E=1 — for the int8-weight
kernels too, whose f32 inputs are quantized with ``kernels.quant`` —
GQA groups 1/2/4,
kv_len < S, wrapped ring positions, window > 0; for the paged kernel
block sizes 1/3/16/32, shuffled tables that share blocks, kv_len = 0
rows and full rows). Every test here skips
without a CUDA device; the module imports neither JAX nor the reference
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 atol=rtol=1e-4 (f32 sums in another order);
bfloat16 atol=rtol=2e-2 compared in float32 (the kernels keep f32
accumulators and round once, the plain versions round each product).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import moe_gmm as MG
from repro_torch.kernels import quant as QT

torch.set_num_threads(1)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# (E, C, D, F, group sizes). bf16 with D and F multiples of 8 takes the
# wgmma path (csrc/moe_gmm_sm90.cuh): C 9/64/65/160/200/300 (200 and
# 300: two row groups, N at most 160), D not a multiple of the 64-deep
# stage (40, 200, 4104), F not a multiple of a CTA's 128 or 256 columns
# (72, 136, 200), group sizes 0, 1, C and a partly filled last row
# group, E = 1, and a long D at narrow F (E2 C24 D4104 F136) that wraps
# the stage ring many times.
GMM_CASES = [
    (3, 7, 96, 40, [7, 3, 0]),
    (2, 16, 96, 40, [0, 0]),
    (4, 33, 64, 72, [0, 0, 17, 0]),
    (1, 40, 128, 136, [40]),
    (2, 12, 40, 37, [12, 5]),
    (3, 9, 40, 72, [9, 1, 0]),
    (2, 64, 200, 136, [64, 33]),
    (2, 65, 64, 200, [65, 0]),
    (1, 160, 128, 256, [160]),
    (2, 200, 96, 136, [200, 161]),
    (2, 24, 4104, 136, [24, 7]),
    (2, 300, 64, 72, [300, 257]),
    (3, 40, 4104, 200, [1, 40, 0]),
]

# (B, H, KV, hd, S, kv_len, q_pos, wrapped ring, window)
ATTN_CASES = [
    (2, 4, 4, 32, 24, [24, 10], [23, 9], False, 0),
    (3, 8, 4, 16, 20, [20, 1, 7], [19, 0, 6], False, 0),
    (2, 8, 2, 32, 40, [17, 40], [16, 39], False, 0),
    (2, 4, 1, 16, 16, [16, 16], [40, 16], True, 0),
    (2, 8, 2, 16, 32, [32, 21], [31, 20], False, 8),
    (2, 4, 2, 16, 12, [12, 12], [50, 23], True, 5),
    (2, 4, 2, 18, 50, [50, 31], [49, 30], False, 0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _gmm_case(e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wg = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    return x, wg, wu


def _attn_case(b, h, kvh, hd, s, kv_len, q_pos, wrap, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    kv_len = np.asarray(kv_len, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    slot = np.arange(s, dtype=np.int32)[None]
    if wrap:   # ring holding the last s positions up to q_pos
        pos = q_pos[:, None] - np.mod(q_pos[:, None] - slot, s)
    else:
        pos = np.broadcast_to(slot, (b, s))
    return q, k, v, np.ascontiguousarray(pos, np.int32), kv_len, q_pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernels_match_plain_on_card(cuda, dtype):
    tol = TOL[dtype]
    for e, c, d, f, gs in GMM_CASES:
        x, wg, wu = (torch.from_numpy(a).to(cuda, dtype)
                     for a in _gmm_case(e, c, d, f))
        g = torch.tensor(gs, dtype=torch.int32, device=cuda)
        got = MG.fused_gate_up(x, wg, wu, g)
        torch.testing.assert_close(got.float(),
                                   MG.fused_gate_up_ref(x, wg, wu, g).float(),
                                   atol=tol, rtol=tol)
        past = torch.arange(c, device=cuda)[None] >= g[:, None]
        assert torch.all(got[past] == 0)
        torch.testing.assert_close(MG.gmm(x, wg, g).float(),
                                   MG.gmm_ref(x, wg, g).float(),
                                   atol=tol, rtol=tol)


def _gmm_both(x, wg, wu, g, path=None):
    """(fused_gate_up, gmm) through the kernel on `path` (None: the
    plan's), each held to its plain version at the bf16 tolerance with
    rows past the group size exactly 0."""
    tol = TOL[torch.bfloat16]
    past = torch.arange(x.shape[1], device=x.device)[None] >= g[:, None]
    for name, fused, want in (
            ("fused_gate_up", True, MG.fused_gate_up_ref(x, wg, wu, g)),
            ("gmm", False, MG.gmm_ref(x, wg, g))):
        got = MG._launch(name, fused, x, wg, wu if fused else None, g,
                         path=path)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        assert torch.all(got[past] == 0)


@pytest.mark.cuda
def test_wgmma_paths_match_plain_on_card(cuda):
    """bf16 with D and F multiples of 8 takes "wgmma" by the plan, decode's
    C <= 8 included (N = 8); every such case also forced through the simt
    path, which chip_smoke.py times against the plan's at decode."""
    for e, c, d, f, gs in GMM_CASES + [(8, 3, 96, 136, [3, 1, 0, 2, 3,
                                                          0, 1, 2])]:
        if d % 8 or f % 8:
            continue
        x, wg, wu = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                     for a in _gmm_case(e, c, d, f))
        g = torch.tensor(gs, dtype=torch.int32, device=cuda)
        assert MG.kernel_path(x, wg, fused=True)[0] == "wgmma"
        assert MG.kernel_path(x, wg)[0] == "wgmma"
        for path in (None, "simt"):
            _gmm_both(x, wg, wu, g, path)


@pytest.mark.cuda
def test_misaligned_x_takes_simt_on_card(cuda):
    """x as a contiguous view 2 bytes past an aligned buffer: no TMA
    tensor map can take it, so the plan takes the simt path, which holds
    the plain version."""
    e, c, d, f = 2, 64, 96, 136
    xs, wg, wu = _gmm_case(e, c, d, f)
    buf = torch.zeros(e * c * d + 8, dtype=torch.bfloat16, device=cuda)
    x = buf[1:1 + e * c * d].view(e, c, d)
    x.copy_(torch.from_numpy(xs))
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    wg, wu = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (wg, wu))
    assert MG.kernel_path(x, wg, fused=True)[0] == "simt"
    _gmm_both(x, wg, wu, torch.tensor([64, 30], dtype=torch.int32,
                                      device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain_on_card(cuda, dtype):
    tol = TOL[dtype]
    for b, h, kvh, hd, s, kl, qp, wrap, window in ATTN_CASES:
        q, k, v, pos, kv_len, q_pos = _attn_case(b, h, kvh, hd, s, kl, qp,
                                                 wrap)
        q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
        pos, kv_len, q_pos = (torch.from_numpy(a).to(cuda)
                              for a in (pos, kv_len, q_pos))
        torch.testing.assert_close(
            DA.decode_attention(q, k, v, pos, kv_len, q_pos,
                                window=window).float(),
            DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                    window=window).float(),
            atol=tol, rtol=tol)


# (B, H, KV, hd, blk, nbs, kv_len, window): block sizes 1/3/16/32 (a
# 32-slot tile spans many blocks, one, or part of one), kv_len = 0 and
# full rows, a window, hd = 18 (scalar loads)
PAGED_CASES = [
    (3, 8, 2, 64, 1, 40, [40, 17, 0], 0),
    (3, 8, 4, 32, 3, 13, [39, 20, 5], 0),
    (4, 8, 2, 128, 16, 6, [96, 50, 0, 33], 0),
    (2, 4, 2, 64, 32, 3, [96, 70], 0),
    (3, 8, 2, 64, 16, 5, [80, 61, 30], 12),
    (2, 4, 2, 18, 3, 7, [21, 10], 0),
]


def _paged_case(b, h, kvh, hd, blk, nbs, kv_len, seed=0):
    """A shuffled pool, also the CPU tests' (test_torch_paged_kv.py):
    each row's chain is a random choice of pool blocks, rows 0 and 1
    share their common full prefix blocks, and unassigned table entries
    point at trash block 0."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * nbs
    kv_len = np.asarray(kv_len, np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    tables = np.zeros((b, nbs), np.int32)
    kv_pos = rng.integers(-50, 200, (nb, blk)).astype(np.int32)
    for r in range(b):
        for i in range(-(-int(kv_len[r]) // blk)):
            tables[r, i] = free.pop()
    if b > 1:
        shared = min(kv_len[0], kv_len[1]) // blk
        tables[1, :shared] = tables[0, :shared]
    for r in range(b):
        for i in range(-(-int(kv_len[r]) // blk)):
            kv_pos[tables[r, i]] = i * blk + np.arange(blk)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((nb, blk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((nb, blk, kvh, hd)).astype(np.float32)
    q_pos = np.maximum(kv_len - 1, 0).astype(np.int32)
    return q, k, v, kv_pos, tables, kv_len, q_pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_paged_kernel_matches_plain_on_card(cuda, dtype):
    tol = TOL[dtype]
    for b, h, kvh, hd, blk, nbs, kl, window in PAGED_CASES:
        q, k, v, pos, tab, kv_len, q_pos = _paged_case(b, h, kvh, hd, blk,
                                                       nbs, kl)
        q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
        pos, tab, kv_len, q_pos = (torch.from_numpy(a).to(cuda)
                                   for a in (pos, tab, kv_len, q_pos))
        got = DA.decode_attention_paged(q, k, v, pos, tab, kv_len, q_pos,
                                        window=window)
        want = DA.decode_attention_paged_ref(q, k, v, pos, tab, kv_len,
                                             q_pos, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


# (E, C, D, F, group sizes) of the int8-weight kernels: C = 7, D = 96,
# F = 40 (not a multiple of 16: byte loads), empty slots, E = 1, an
# aligned F with a split D reduction, and C > 8 (bf16: the tensor-core
# path) with partial row, column and depth tiles
QUANT_CASES = [
    (3, 7, 96, 40, [7, 3, 0]),
    (2, 16, 96, 40, [0, 0]),
    (1, 7, 96, 40, [5]),
    (4, 3, 512, 64, [3, 0, 1, 2]),
    (3, 40, 96, 48, [40, 17, 0]),
    (2, 70, 200, 64, [70, 65]),
]


def _quant_case(e, c, d, f, device, dtype, seed=0):
    x, wg, wu = _gmm_case(e, c, d, f, seed)
    qg, sg = QT.quantize_rows(torch.from_numpy(wg))
    qu, su = QT.quantize_rows(torch.from_numpy(wu))
    return (torch.from_numpy(x).to(device, dtype),
            *(t.to(device) for t in (qg, sg, qu, su)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_match_plain_on_card(cuda, dtype):
    tol = TOL[dtype]
    for e, c, d, f, gs in QUANT_CASES:
        x, qg, sg, qu, su = _quant_case(e, c, d, f, cuda, dtype)
        g = torch.tensor(gs, dtype=torch.int32, device=cuda)
        got = MG.fused_gate_up_quant(x, qg, sg, qu, su, g)
        assert got.dtype == dtype
        torch.testing.assert_close(
            got.float(),
            MG.fused_gate_up_quant_ref(x, qg, sg, qu, su, g).float(),
            atol=tol, rtol=tol)
        past = torch.arange(c, device=cuda)[None] >= g[:, None]
        assert torch.all(got[past] == 0)
        got = MG.gmm_quant(x, qg, sg, g)
        torch.testing.assert_close(
            got.float(), MG.gmm_quant_ref(x, qg, sg, g).float(),
            atol=tol, rtol=tol)
        assert torch.all(got[past] == 0)


def test_quant_kernels_cuda_impl_rejects_cpu_tensors():
    """impl='cuda' on CPU tensors raises for both int8-weight kernels
    (no fallback to the plain version)."""
    from repro_torch.kernels import ops as OPS
    e, c, d, f, gs = QUANT_CASES[0]
    x, qg, sg, qu, su = _quant_case(e, c, d, f, "cpu", torch.float32)
    qd, sd = QT.quantize_rows(torch.from_numpy(_gmm_case(e, c, f, d)[1]))
    g = torch.tensor(gs, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        OPS.expert_ffn_quant_impl(x, qg, sg, qu, su, qd, sd, g, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        OPS.gmm_quant_impl(x, qg, sg, g, "cuda")
