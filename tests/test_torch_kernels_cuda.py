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


def _attn_case(b, h, kvh, hd, s, kv_len, q_pos, wrap, seed=0, past=None):
    """Seeded inputs; with `past`, k and v hold that value in every lane
    at or past the row's kv_len (a lane the result must not weigh unless
    the row has no visible lane)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    kv_len = np.asarray(kv_len, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    if past is not None:
        for r in range(b):
            k[r, kv_len[r]:] = past
            v[r, kv_len[r]:] = past
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


def _paged_case(b, h, kvh, hd, blk, nbs, kv_len, seed=0, past=None,
                q_pos=None):
    """A shuffled pool, also the CPU tests' (test_torch_paged_kv.py):
    each row's chain is a random choice of pool blocks, rows 0 and 1
    share their common full prefix blocks, and unassigned table entries
    point at trash block 0. q_pos defaults to kv_len - 1 (at least 0);
    with `past`, k and v hold that value in block 0 and in every chain
    lane at or past the row's kv_len."""
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
    if q_pos is None:
        q_pos = np.maximum(kv_len - 1, 0)
    q_pos = np.asarray(q_pos, np.int32)
    if past is not None:
        for t in (k, v):
            t[0] = past
            for r in range(b):
                n = int(kv_len[r])
                if n % blk:
                    t[tables[r, n // blk], n % blk:] = past
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


def _to_card(device, dtype, *arrays):
    """numpy inputs on the card: floats in `dtype`, ints as they are."""
    out = [torch.from_numpy(np.array(a)) for a in arrays]
    return [t.to(device, dtype) if t.is_floating_point() else t.to(device)
            for t in out]


def _want_path(dtype, hd):
    return "mma" if dtype == torch.bfloat16 and hd % 16 == 0 else "simt"


# rows of the hidden-row cases: kv_len = 0; every lane below kv_len
# hidden by position (q_pos = -1); a partial row; a full row; and, under
# the window of 16, a row whose lanes are all older than the window
HIDDEN_KV_LEN = [0, 10, 23, 40, 20]
HIDDEN_Q_POS = [5, -1, 22, 39, 100]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [18, 64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_decode_attention_hidden_rows_on_card(cuda, dtype, hd, g):
    """G = H/KV of 1, 4 and 8 at hd 18, 64 and 128: rows with no visible
    lane (kv_len = 0, hidden by position, hidden by the window) average v
    over all S lanes, and lanes past kv_len hold 1e4 in k and v, so a
    kernel that weighs any of them in a row with a visible lane fails.
    bf16 with hd % 16 == 0 takes "mma", everything else "simt"."""
    tol = TOL[dtype]
    b, kvh, s = len(HIDDEN_KV_LEN), 2, 40
    args = _to_card(cuda, dtype, *_attn_case(
        b, g * kvh, kvh, hd, s, HIDDEN_KV_LEN, HIDDEN_Q_POS, False,
        past=1e4))
    assert DA.kernel_path(*args[:3])[0] == _want_path(dtype, hd)
    for window in (0, 16):
        torch.testing.assert_close(
            DA.decode_attention(*args, window=window).float(),
            DA.decode_attention_ref(*args, window=window).float(),
            atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_extremes_on_card(cuda, dtype):
    """An unsplit grid (B * KV = 288 >= 2 CTAs an SM: one CTA a group)
    and the largest split (one group, a long row: clusters of 8)."""
    tol = TOL[dtype]
    b, h, kvh, hd, s = 36, 32, 8, 128, 40
    kl = [40 - i % 9 for i in range(b)]
    args = _to_card(cuda, dtype, *_attn_case(
        b, h, kvh, hd, s, kl, [x - 1 for x in kl], False, past=1e4))
    assert DA.kernel_path(*args[:3])[1]["nsplit"] == 1
    torch.testing.assert_close(DA.decode_attention(*args).float(),
                               DA.decode_attention_ref(*args).float(),
                               atol=tol, rtol=tol)
    args = _to_card(cuda, dtype, *_attn_case(
        1, 4, 1, 128, 2000, [1777], [1776], False, past=1e4))
    assert DA.kernel_path(*args[:3])[1]["nsplit"] == 8
    for window in (0, 300):
        torch.testing.assert_close(
            DA.decode_attention(*args, window=window).float(),
            DA.decode_attention_ref(*args, window=window).float(),
            atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blk", [1, 3, 16, 32])
def test_decode_attention_paged_hidden_rows_on_card(cuda, dtype, blk):
    """The paged kernel on the hidden-row rows, with 1e4 in pool block 0
    (where unassigned table entries point) and in every chain lane past
    kv_len; a row with no visible lane averages all nbs * blk lanes, the
    trash block's included."""
    tol = TOL[dtype]
    nbs = -(-40 // blk)
    kl = [0, 10, 23, nbs * blk, 20]
    qp = [5, -1, 22, nbs * blk - 1, 100]
    for hd in (18, 128):
        args = _to_card(cuda, dtype, *_paged_case(
            len(kl), 8, 2, hd, blk, nbs, kl, past=1e4, q_pos=qp))
        assert DA.kernel_path(*args[:3], block_tables=args[4])[0] == \
            _want_path(dtype, hd)
        for window in (0, 16):
            torch.testing.assert_close(
                DA.decode_attention_paged(*args, window=window).float(),
                DA.decode_attention_paged_ref(*args, window=window).float(),
                atol=tol, rtol=tol)


@pytest.mark.cuda
def test_decode_attention_misaligned_kv_takes_simt_on_card(cuda):
    """bf16 k/v as contiguous views 2 bytes past an aligned buffer: no
    16-byte copy can take them, so both launches take the simt path,
    which holds the plain version."""
    tol = TOL[torch.bfloat16]

    def offset(a):
        buf = torch.zeros(a.size + 8, dtype=torch.bfloat16, device=cuda)
        t = buf[1:1 + a.size].view(a.shape)
        t.copy_(torch.from_numpy(a))
        assert t.is_contiguous() and t.data_ptr() % 16 == 2
        return t

    q, k, v, pos, kv_len, q_pos = _attn_case(
        5, 8, 2, 64, 40, HIDDEN_KV_LEN, HIDDEN_Q_POS, False, past=1e4)
    q, pos, kv_len, q_pos = _to_card(cuda, torch.bfloat16, q, pos, kv_len,
                                     q_pos)
    k, v = offset(k), offset(v)
    assert DA.kernel_path(q, k, v)[0] == "simt"
    torch.testing.assert_close(
        DA.decode_attention(q, k, v, pos, kv_len, q_pos).float(),
        DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos).float(),
        atol=tol, rtol=tol)
    q, k, v, pos, tab, kv_len, q_pos = _paged_case(
        3, 8, 2, 64, 16, 3, [40, 0, 17], past=1e4)
    q, pos, tab, kv_len, q_pos = _to_card(cuda, torch.bfloat16, q, pos, tab,
                                          kv_len, q_pos)
    k, v = offset(k), offset(v)
    assert DA.kernel_path(q, k, v, block_tables=tab)[0] == "simt"
    torch.testing.assert_close(
        DA.decode_attention_paged(q, k, v, pos, tab, kv_len, q_pos).float(),
        DA.decode_attention_paged_ref(q, k, v, pos, tab, kv_len,
                                      q_pos).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [18, 128])
def test_decode_attention_stats_match_plain_on_card(cuda, dtype, hd):
    """``return_stats=True`` on the "mma" and "simt" paths: the float32
    output, m and l against the plain version's (m and l to the output's
    tolerance: the kernel rounds q * scale to the input type before the
    dot, as the TPU kernel does, the plain version does not), m =
    NEG_INF and l = S exactly on the rows with no visible lane (kv_len 0
    among them), and with the window; the output rounded to the input
    type equals a launch without statistics bit for bit, which is what
    that launch computed before the option existed."""
    tol = TOL[dtype]
    b, kvh, s = len(HIDDEN_KV_LEN), 2, 40
    args = _to_card(cuda, dtype, *_attn_case(
        b, 4 * kvh, kvh, hd, s, HIDDEN_KV_LEN, HIDDEN_Q_POS, False,
        past=1e4))
    assert DA.kernel_path(*args[:3])[0] == _want_path(dtype, hd)
    for window in (0, 16):
        out, m, l = DA.decode_attention(*args, window=window,
                                        return_stats=True)
        want = DA.decode_attention_ref(*args, window=window,
                                       return_stats=True)
        assert out.dtype == m.dtype == l.dtype == torch.float32
        for got, w in zip((out, m, l), want):
            torch.testing.assert_close(got, w, atol=tol, rtol=tol)
        hidden = want[1] == DA.NEG_INF
        assert hidden[0].all()                      # kv_len 0
        assert torch.equal(m[hidden], want[1][hidden])
        assert torch.all(l[hidden] == s)
        plain = DA.decode_attention(*args, window=window)
        assert torch.equal(out.to(dtype), plain)


@pytest.mark.cuda
def test_decode_attention_graph_capture_on_card(cuda):
    """Three calls (contiguous bf16, paged bf16, contiguous f32) captured
    in one CUDA graph: a replay gives the eager calls' outputs bit for
    bit, and after kv_len changes in place, the new eager outputs."""
    cont = _to_card(cuda, torch.bfloat16, *_attn_case(
        5, 8, 2, 128, 40, HIDDEN_KV_LEN, HIDDEN_Q_POS, False, past=1e4))
    paged = _to_card(cuda, torch.bfloat16, *_paged_case(
        3, 8, 2, 128, 16, 3, [40, 0, 17], past=1e4))
    f32 = _to_card(cuda, torch.float32, *_attn_case(
        2, 8, 2, 64, 30, [30, 11], [29, 10], False, past=1e4))

    def calls():
        return (DA.decode_attention(*cont), DA.decode_attention_paged(*paged),
                DA.decode_attention(*f32))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for step in range(2):
        if step:   # shorter rows: the replay reads the new lengths
            for args in (cont, paged, f32):
                args[-2].copy_(torch.clamp(args[-2] - 3, min=0))
        graph.replay()
        eager = calls()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


# (E, C, D, F, group sizes) of the int8-weight kernels: C = 7, D = 96,
# F = 40 (not a multiple of 16: simt with byte loads), empty slots,
# E = 1, an aligned F with a split D reduction (f32), C > 8 with partial
# row, column and depth tiles; then the edges of the bf16 wgmma path
# (D % 8 == 0, F % 16 == 0): C = 1, 8 and 9 (N = 8 and 16), 160 (one row
# group of N = 160), 161 and 320 (two row groups of 96 and 160), D = 200
# (a tail past the 64-deep stage), F = 144 (a multiple of 16, not of a
# CTA's 128 or 256 columns), experts of 100, 70 and 33 rows at C = 160,
# 64 slots of which 16 have rows, and all-zero group sizes
QUANT_CASES = [
    (3, 7, 96, 40, [7, 3, 0]),
    (2, 16, 96, 40, [0, 0]),
    (1, 7, 96, 40, [5]),
    (4, 3, 512, 64, [3, 0, 1, 2]),
    (3, 40, 96, 48, [40, 17, 0]),
    (2, 70, 200, 64, [70, 65]),
    (2, 1, 96, 48, [1, 0]),
    (2, 8, 128, 144, [8, 5]),
    (3, 9, 200, 64, [9, 1, 0]),
    (1, 160, 128, 256, [160]),
    (2, 161, 200, 144, [161, 9]),
    (2, 320, 64, 48, [320, 161]),
    (3, 160, 64, 48, [100, 70, 33]),
    (64, 3, 128, 144, [(i % 3) + 1 if i % 4 == 1 else 0 for i in range(64)]),
    (2, 16, 96, 48, [0, 0]),
]


def _want_qpath(dtype, d, f):
    """The int8 kernels' path by the plan: bf16 with D % 8 == 0 and
    F % 16 == 0 (aligned operands) takes "wgmma", the rest "simt"."""
    ok = dtype == torch.bfloat16 and d % 8 == 0 and f % 16 == 0
    return "wgmma" if ok else "simt"


def _quant_case(e, c, d, f, device, dtype, seed=0):
    x, wg, wu = _gmm_case(e, c, d, f, seed)
    qg, sg = QT.quantize_rows(torch.from_numpy(wg))
    qu, su = QT.quantize_rows(torch.from_numpy(wu))
    return (torch.from_numpy(x).to(device, dtype),
            *(t.to(device) for t in (qg, sg, qu, su)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_match_plain_on_card(cuda, dtype):
    """Every case through both kernels on the plan's path (asserted, and
    counted on that path), held to the plain version with rows past the
    group size exactly 0."""
    tol = TOL[dtype]
    for e, c, d, f, gs in QUANT_CASES:
        x, qg, sg, qu, su = _quant_case(e, c, d, f, cuda, dtype)
        g = torch.tensor(gs, dtype=torch.int32, device=cuda)
        want_path = _want_qpath(dtype, d, f)
        assert MG.quant_plan(x, qg, scale=sg)[0] == want_path
        before = {n: dict(v) for n, v in MG.QUANT_PATH_LAUNCHES.items()}
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
        for name in MG.QUANT_PATH_LAUNCHES:
            assert MG.QUANT_PATH_LAUNCHES[name][want_path] == \
                before[name][want_path] + 1


@pytest.mark.cuda
def test_quant_misaligned_x_takes_simt_on_card(cuda):
    """bf16 x as a contiguous view 2 bytes past an aligned buffer: no TMA
    tensor map can take it, so both int8 kernels take the simt path,
    which holds the plain version."""
    tol = TOL[torch.bfloat16]
    e, c, d, f, gs = 2, 64, 96, 144, [64, 30]
    xa, qg, sg, qu, su = _quant_case(e, c, d, f, cuda, torch.bfloat16)
    buf = torch.zeros(xa.numel() + 8, dtype=torch.bfloat16, device=cuda)
    x = buf[1:1 + xa.numel()].view(xa.shape)
    x.copy_(xa)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert MG.quant_plan(x, qg, scale=sg)[0] == "simt"
    g = torch.tensor(gs, dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        MG.fused_gate_up_quant(x, qg, sg, qu, su, g).float(),
        MG.fused_gate_up_quant_ref(x, qg, sg, qu, su, g).float(),
        atol=tol, rtol=tol)
    torch.testing.assert_close(MG.gmm_quant(x, qg, sg, g).float(),
                               MG.gmm_quant_ref(x, qg, sg, g).float(),
                               atol=tol, rtol=tol)


def _slot_bank(device, e, d, f, gen):
    """An int8 bank (E, D, F) with f32 row scales (E, D), made on the
    card from a seeded generator: values in [-127, 127], scales so that
    the dequantized weights are ~1/sqrt(D)."""
    q = torch.randint(-127, 128, (e, d, f), generator=gen, device=device,
                      dtype=torch.int8)
    s = torch.rand((e, d), generator=gen, device=device) \
        .add_(0.5).mul_(1.7 / (127 * d ** 0.5))
    return q, s


@pytest.mark.cuda
def test_quant_wgmma_matches_simt_at_decode_on_card(cuda):
    """mixtral-8x7b's decode shapes on the EP slot plane (64 slots, 16
    with 1-3 rows, C = 3): the plan's wgmma path and the forced simt path
    agree within the bf16 tolerance, for both kernels."""
    tol = TOL[torch.bfloat16]
    gen = torch.Generator(device=cuda).manual_seed(0)
    rng = np.random.default_rng(0)
    gs = [0] * 64
    for i in rng.choice(64, 16, replace=False):
        gs[i] = int(rng.integers(1, 4))
    g = torch.tensor(gs, dtype=torch.int32, device=cuda)
    for fused, d, f in ((True, 4096, 14336), (False, 14336, 4096)):
        x = torch.randn((64, 3, d), generator=gen, device=cuda) \
            .to(torch.bfloat16)
        qs = [_slot_bank(cuda, 64, d, f, gen) for _ in range(2 if fused
                                                              else 1)]
        name = "fused_gate_up_quant" if fused else "gmm_quant"
        assert MG.quant_plan(x, qs[0][0], 16, scale=qs[0][1])[0] == "wgmma"
        out = {p: MG._launch_quant(name, fused, x, qs, g, 16, path=p)
               for p in ("wgmma", "simt")}
        torch.testing.assert_close(out["wgmma"].float(),
                                   out["simt"].float(), atol=tol, rtol=tol)
        assert torch.all(out["wgmma"][g == 0] == 0)
        del qs, out
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_quant_graph_capture_on_card(cuda):
    """One fused_gate_up_quant launch on the wgmma path captured in a
    CUDA graph (its tensor maps are kernel parameters, encoded at
    capture): a replay gives the eager output bit for bit, and after x
    and the group sizes change in place, the new eager output."""
    x, qg, sg, qu, su = _quant_case(4, 9, 200, 144, cuda, torch.bfloat16)
    g = torch.tensor([9, 0, 4, 1], dtype=torch.int32, device=cuda)
    assert MG.quant_plan(x, qg, scale=sg)[0] == "wgmma"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        MG.fused_gate_up_quant(x, qg, sg, qu, su, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = MG.fused_gate_up_quant(x, qg, sg, qu, su, g)
    for step in range(2):
        if step:
            x.mul_(-0.5)
            g.copy_(torch.tensor([3, 9, 0, 7], dtype=torch.int32))
        graph.replay()
        eager = MG.fused_gate_up_quant(x, qg, sg, qu, su, g)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


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


def test_launch_counts_survive_concurrent_bumps():
    """Launch counters bumped from more threads than cores, with the
    interpreter switching threads as often as it can, lose no count,
    and a reset under the same lock zeroes them."""
    import sys
    import threading

    from repro_torch import kernels as K
    K.reset_launch_counts()
    names = list(MG.LAUNCHES) + list(DA.LAUNCHES)
    per_thread = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            (DA.LAUNCHES if names[i % len(names)] in DA.LAUNCHES
             else MG.LAUNCHES).bump(names[i % len(names)])
            for _ in range(per_thread)]) for i in range(4 * len(names))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert K.launch_counts() == {n: 4 * per_thread for n in names}
    K.reset_launch_counts()
    assert set(K.launch_counts().values()) == {0}


@pytest.mark.cuda
def test_launch_counts_add_up_across_engine_threads(cuda):
    """Two engines stepped from two threads (as the gateway's replicas
    are) count exactly the launches the same two runs count one after
    the other."""
    import threading

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    cfg = get_config("mixtral-8x7b", smoke=True)
    params = init_params(cfg, 0, device=cuda)

    def serve():
        rng = np.random.default_rng(0)
        reqs = [GenRequest(rid=i, arrival=0.0, max_new_tokens=12,
                           prompt=rng.integers(0, cfg.vocab_size, 9 + i,
                                               dtype=np.int32),
                           sampling=SamplingParams(temperature=0.7 * (i % 2),
                                                   seed=i))
                for i in range(4)]
        ServingEngine(cfg, params, max_len=32).serve(reqs, num_slots=4)

    serve()                      # builds the kernels on this thread
    K.reset_launch_counts()
    serve()
    serve()
    sequential = K.launch_counts()
    K.reset_launch_counts()
    threads = [threading.Thread(target=serve) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert K.launch_counts() == sequential
    assert sequential["fused_gate_up"] > 0 and \
        sequential["decode_attention"] > 0


@pytest.mark.cuda
def test_sampling_args_reach_the_card_without_host_sync(cuda):
    """A session's per-slot sampling arrays go to the card in one copy
    that does not block the host (sync debug mode 'error') and arrive
    equal to the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    cfg = get_config("mixtral-8x7b", smoke=True)
    eng = ServingEngine(cfg, init_params(cfg, 0, device=cuda), max_len=32)
    eng.start(num_slots=4)
    sess = eng._session
    for slot, t in ((1, 0.8), (3, 1.3)):
        sess.bind_slot(slot, GenRequest(
            rid=slot, arrival=0.0, prompt=np.arange(4, dtype=np.int32),
            max_new_tokens=4, sampling=SamplingParams(
                temperature=t, top_k=50, top_p=0.9, seed=-slot)))
    sess.count[3] += 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sess.sampling_args(cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, sess.sampling_args("cpu")):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    eng.close()


@pytest.mark.cuda
def test_sampler_on_card_matches_cpu_without_host_sync(cuda):
    """``sample_tokens`` on the card makes no host sync (sync debug mode
    'error'), its threefry bits and Gumbel draws equal the CPU's bit for
    bit, and its tokens equal the CPU's where no top-p nucleus is cut
    (the nucleus boundary rests on a float cumulative sum whose order
    differs by device)."""
    from repro_torch.models import prng
    from repro_torch.models.transformer import sample_tokens
    rng = np.random.default_rng(0)
    b, v = 24, 32000
    logits = torch.from_numpy(
        (rng.standard_normal((b, v)) * 3).astype(np.float32))
    t = torch.tensor(([0.0, 0.5, 0.8, 1.3] * 6), dtype=torch.float32)
    k = torch.tensor(([0, 1, 50] * 8), dtype=torch.int32)
    p = torch.tensor(([1.0] * 3 + [0.9] * 3) * 4, dtype=torch.float32)
    seed = torch.from_numpy(rng.integers(-2**31, 2**31, b).astype(np.int32))
    step = torch.from_numpy(rng.integers(0, 1000, b).astype(np.int32))
    args = (t, k, p, seed, step)
    want = sample_tokens(logits, *args)
    dev_args = [a.to(cuda) for a in args]
    dev_logits = logits.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sample_tokens(dev_logits, *dev_args)
        keys = prng.fold_in(prng.key(dev_args[3]), dev_args[4])
        draws = prng.gumbel(keys, 1000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu_keys = prng.fold_in(prng.key(seed), step)
    assert torch.equal(keys.cpu(), cpu_keys)
    assert torch.equal(draws.cpu().view(torch.int32),
                       prng.gumbel(cpu_keys, 1000).view(torch.int32))
    uncut = (p >= 1.0).numpy()
    np.testing.assert_array_equal(got.cpu().numpy()[uncut],
                                  want.numpy()[uncut])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "qwen3-32b"])
def test_decode_step_strided_positions_reach_the_kernel(cuda, arch):
    """A decode step whose query positions are a strided view (qwen2-vl's
    explicit (B, 1, 3) M-RoPE positions; a scalar cache length over a
    batch, broadcast to every row) launches the decode-attention kernel
    and matches the plain path within the float32 tolerance."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    b, plen = 3, 6
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                         device=cuda)
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        device=cuda)
    batch = {"tokens": nxt}
    if cfg.rope == "mrope":
        batch["positions"] = torch.tensor(
            [[[plen, 2, 3]], [[plen, 0, 1]], [[plen + 4, 1, 1]]],
            dtype=torch.int32, device=cuda)
    outs = []
    for c in (cfg, cfg.with_(impl="ref")):
        cache = T.init_cache(c, params, b, 16)
        T.decode_step(c, params, {"tokens": toks}, cache, 0)
        K.reset_launch_counts()
        lg, _, _ = T.decode_step(c, params, batch, cache, plen)
        outs.append((lg, K.launch_counts()["decode_attention"]))
    assert outs[0][1] == cfg.num_layers and outs[1][1] == 0
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_autograd_on_card(cuda):
    """No kernel has a backward: under grad mode each wrapper (the bf16
    and int8 expert kernels, both decode attentions) refuses an input
    that requires grad (NotImplementedError naming it, no launch),
    and under ``torch.no_grad()`` launches its kernel on the same
    tensors and holds the plain version."""
    from repro_torch.kernels import launch_counts
    dt, tol = torch.bfloat16, TOL[torch.bfloat16]
    x, wg, wu = _to_card(cuda, dt, *_gmm_case(2, 24, 64, 72))
    g = torch.tensor([24, 9], dtype=torch.int32, device=cuda)
    q, k, v, pos, kv_len, q_pos = _to_card(cuda, dt, *_attn_case(
        *ATTN_CASES[2][:8]))
    pq, pk, pv, ppos, tab, pkv_len, pq_pos = _to_card(cuda, dt, *_paged_case(
        2, 8, 2, 32, 16, 3, [40, 17]))
    qx, qg, sg, qu, su = _quant_case(2, 24, 64, 80, cuda, dt)
    calls = {
        "fused_gate_up": (lambda: MG.fused_gate_up(x, wg, wu, g),
                          lambda: MG.fused_gate_up_ref(x, wg, wu, g), wg),
        "gmm": (lambda: MG.gmm(x, wg, g), lambda: MG.gmm_ref(x, wg, g), x),
        "decode_attention": (
            lambda: DA.decode_attention(q, k, v, pos, kv_len, q_pos),
            lambda: DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                            window=0), k),
        "decode_attention_paged": (
            lambda: DA.decode_attention_paged(pq, pk, pv, ppos, tab,
                                              pkv_len, pq_pos),
            lambda: DA.decode_attention_paged_ref(pq, pk, pv, ppos, tab,
                                                  pkv_len, pq_pos,
                                                  window=0), pq),
        "fused_gate_up_quant": (
            lambda: MG.fused_gate_up_quant(qx, qg, sg, qu, su, g),
            lambda: MG.fused_gate_up_quant_ref(qx, qg, sg, qu, su, g), su),
        "gmm_quant": (lambda: MG.gmm_quant(qx, qg, sg, g),
                      lambda: MG.gmm_quant_ref(qx, qg, sg, g), qx),
    }
    for name, (kernel, plain, needs_grad) in calls.items():
        needs_grad.requires_grad_(True)
        before = launch_counts()[name]
        with pytest.raises(NotImplementedError, match=name):
            kernel()
        assert launch_counts()[name] == before
        with torch.no_grad():
            got, want = kernel(), plain()
        assert launch_counts()[name] == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        needs_grad.requires_grad_(False)


@pytest.mark.cuda
def test_whisper_decode_and_gelu_experts_match_plain_on_card(cuda):
    """whisper-base's decode geometry (B 8, H 8, KV 8, hd 64) through
    ``decode_attention`` in bf16, on "mma", against the plain version; a
    whisper decode step at its widths (2 decoder layers, a 64-frame
    encoder, float32) through the kernels against the plain path, one
    launch a layer; and gelu experts (``gmm`` up, gelu, ``gmm`` down,
    bf16 and int8 banks) against their plain versions."""
    from repro_torch import kernels as K
    from repro_torch.configs import EncDecSpec, get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    dt, tol = torch.bfloat16, TOL[torch.bfloat16]
    q, k, v, pos, kv_len, q_pos = _to_card(cuda, dt, *_attn_case(
        8, 8, 8, 64, 160, [132] * 4 + [5, 60, 160, 1],
        [131] * 4 + [4, 59, 159, 0], False))
    assert DA.kernel_path(q, k, v)[0] == "mma"
    torch.testing.assert_close(
        DA.decode_attention(q, k, v, pos, kv_len, q_pos).float(),
        DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                window=0).float(), atol=tol, rtol=tol)

    cfg = get_config("whisper-base").with_(
        num_layers=2, dtype="float32",
        encdec=EncDecSpec(num_encoder_layers=1, encoder_seq_len=64))
    params = init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (8, 6), generator=gen,
                         device=cuda)
    emb = torch.randn((8, 64, cfg.d_model), generator=gen,
                      device=cuda) * 0.02
    enc_out = T.run_encoder(cfg, params, emb)
    outs = []
    for c in (cfg, cfg.with_(impl="ref")):
        cache = T.init_cache(c, params, 8, 16)
        T.decode_step(c, params, {"tokens": toks[:, :5], "enc_out": enc_out},
                      cache, 0)
        K.reset_launch_counts()
        lg, _, _ = T.decode_step(c, params, {"tokens": toks[:, 5:],
                                             "enc_out": enc_out}, cache, 5)
        outs.append((lg, K.launch_counts()["decode_attention"]))
    assert outs[0][1] == cfg.num_layers and outs[1][1] == 0
    torch.testing.assert_close(outs[0][0], outs[1][0],
                               atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])

    x, wu, _ = _gmm_case(3, 24, 64, 80)
    wd = np.random.default_rng(3).standard_normal((3, 80, 64)) \
        .astype(np.float32) / np.sqrt(80)
    g = torch.tensor([24, 9, 0], dtype=torch.int32, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        xc, wuc, wdc = _to_card(cuda, dtype, x, wu, wd)
        bank = {"w_up": wuc, "w_down": wdc}
        for p in (bank, QT.quantize_expert_bank(bank)):
            K.reset_launch_counts()
            got = MOE.experts_ffn(p, xc, "gelu", group_sizes=g, impl="cuda")
            n = K.launch_counts()
            name = "gmm_quant" if "w_up_scale" in p else "gmm"
            assert n[name] == 2 and n["fused_gate_up"] == 0, n
            want = MOE.experts_ffn(p, xc, "gelu", group_sizes=g, impl="ref")
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernels_on_f_shards_on_card(cuda, dtype):
    """The tensor-parallel prefill's operands on a (1, 2) mesh: each
    rank's F-columns of w_gate and w_up and its F-rows of w_down, cut by
    ``sharding.shard_tree(copy=True)`` (contiguous tensors of their
    own), through ``fused_gate_up`` and ``gmm`` against their plain
    versions; the two ranks' down products summed equal the whole
    bank's product; a shard left a view (not contiguous) raises."""
    from collections import OrderedDict

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import ProcessMesh
    tol = TOL[dtype]
    e, c, d, f = 4, 40, 96, 272
    x, wg, wu = _gmm_case(e, c, d, f, seed=5)
    wd = np.random.default_rng(6).standard_normal((e, f, d)) \
        .astype(np.float32) / np.sqrt(f)
    x = torch.from_numpy(x).to(cuda, dtype)
    bank = {k: torch.from_numpy(v).to(cuda, dtype)
            for k, v in (("w_gate", wg), ("w_up", wu), ("w_down", wd))}
    g = torch.tensor([c, 17, 0, 33], dtype=torch.int32, device=cuda)
    total = torch.zeros((e, c, d), dtype=torch.float32, device=cuda)
    for r in range(2):
        mesh = ProcessMesh(shape=OrderedDict(data=1, model=2), rank=r,
                           coords=(0, r), device=cuda)
        specs = SH.params_shardings(bank, mesh, fsdp=False)
        assert [SH.model_dim(specs[k]) for k in bank] == [2, 2, 1]
        mine = SH.shard_tree(bank, specs, copy=True)
        assert all(t.is_contiguous() for t in mine.values())
        h = MG.fused_gate_up(x, mine["w_gate"], mine["w_up"], g)
        torch.testing.assert_close(
            h.float(), MG.fused_gate_up_ref(x, mine["w_gate"], mine["w_up"],
                                            g).float(), atol=tol, rtol=tol)
        y = MG.gmm(h, mine["w_down"], g)
        torch.testing.assert_close(
            y.float(), MG.gmm_ref(h, mine["w_down"], g).float(), atol=tol,
            rtol=tol)
        total += y.float()
        views = SH.shard_tree(bank, specs)
        with pytest.raises(ValueError, match="contiguous"):
            MG.fused_gate_up(x, views["w_gate"], views["w_up"], g)
        with pytest.raises(ValueError, match="contiguous"):
            MG.gmm(h, views["w_down"], g)
    whole = MG.gmm_ref(MG.fused_gate_up_ref(x, bank["w_gate"], bank["w_up"],
                                            g), bank["w_down"], g)
    torch.testing.assert_close(total, whole.float(), atol=tol, rtol=tol)


ZERO3_SCRIPT = r'''
import sys
import torch
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import build as KB
from repro_torch.launch.mesh import make_process_mesh, spawn_local
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import _leaves


def world(rank):
    mesh = make_process_mesh(2, 1, device="cuda:0")
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="bfloat16",
                                                      impl="auto")
    params = M.init_params(cfg, 0, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 64),
                                     generator=torch.Generator()
                                     .manual_seed(3), dtype=torch.int32)}
    T.set_moe_dispatch_groups(2)
    out = {}
    with torch.no_grad():
        for fsdp in (False, True):
            ps = SH.params_shardings(params, mesh, fsdp=fsdp)
            step = M.make_prefill_step(cfg, param_shardings=ps)
            shards = SH.shard_tree(params, ps, copy=True)
            K.reset_launch_counts()
            logits, m = step(shards, batch)
            torch.cuda.synchronize()
            out[fsdp] = {"logits": logits.float().cpu(),
                         "loads": m["expert_load"].cpu(),
                         "launches": dict(K.launch_counts()),
                         "bytes": sum(t.numel() * t.element_size()
                                      for t in _leaves(shards)),
                         "gathered": dict(mesh.nbytes)}
    return out


if __name__ == "__main__":
    KB.build()
    ranks = spawn_local(world, 2, backend="gloo", wall_s=300.0)
    torch.save(ranks, sys.argv[1])
'''


@pytest.mark.cuda
def test_zero3_prefill_through_the_kernels_on_card(cuda, tmp_path):
    """The ZeRO-3 prefill (``params_shardings(fsdp=True)``) of the
    mixtral smoke config at bf16 on a (2, 1) mesh of two ranks sharing
    the card over gloo (NCCL refuses two ranks on one device), through
    ``fused_gate_up`` and ``gmm``, against the ``fsdp=False`` step on the
    same mesh: logits and loads bit for bit, both launching each expert
    kernel once a layer, each rank holding half the parameter bytes.
    The ranks run in a subprocess that spawns them."""
    import os
    import pathlib
    import subprocess
    import sys
    script = tmp_path / "zero3.py"
    script.write_text(ZERO3_SCRIPT)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "out.pt")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for r in torch.load(tmp_path / "out.pt"):
        z2, z3 = r[False], r[True]
        assert torch.equal(z3["logits"], z2["logits"])
        assert torch.equal(z3["loads"], z2["loads"])
        for k in ("fused_gate_up", "gmm"):
            assert z3["launches"][k] == z2["launches"][k] == 2
        assert z3["bytes"] * 2 == z2["bytes"]
        assert z3["gathered"]["all_gather/data/params"] == z2["bytes"]
