"""Percentiles, rates, rooflines and model FLOPs, against arithmetic done
by hand and against the bounds of PERF.md's kernel table."""
from __future__ import annotations

import math
from types import SimpleNamespace as NS

import numpy as np
import pytest

from perfbench.core import harness as H
from perfbench.core import readers as R
from perfbench.core import roofline as RF
from perfbench.core import stats as ST


def test_p95_counts_failures_above_every_value():
    vals = list(range(1, 101))                  # 100 finished
    assert ST.percentile(vals, 95) == 95
    # 5 unfinished of 105: rank ceil(0.95 * 105) = 100 is still a value
    assert ST.percentile(vals, 95, missing=5) == 100
    # 6 unfinished of 106: rank 101 falls on a missing request
    assert ST.percentile(vals, 95, missing=6) is None
    assert ST.percentile([], 95) is None


def test_spread_is_quartile_distance_over_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = 10.75, 12.5, 14.25           # statistics' exclusive
    assert ST.spread(v) == pytest.approx((q3 - q1) / med)


def _rec(due, times, max_new, done=True):
    return NS(due=due, times=times, req=NS(max_new=max_new),
              handle=NS(finish_reason="length" if done else ""))


def test_ttft_and_itl_over_the_window_with_an_unfinished_request():
    ctx = NS(window=[_rec(0.0, [0.1, 0.2, 0.4], 3),
                     _rec(1.0, [1.3, 1.35], 2),
                     _rec(2.0, [2.5], 4, done=False)])
    vals, missing = R.ttft_ms(ctx)
    assert vals == pytest.approx([100.0, 300.0]) and missing == 1
    gaps, missing = R.itl_ms(ctx)
    assert sorted(gaps) == pytest.approx([50.0, 100.0, 200.0])
    assert missing == 3                       # 4 tokens due, 1 came
    # 3 gaps and 3 missing: the 50th percentile is the third gap, the
    # 95th falls on a missing one
    assert R.percentile(gaps, missing, q=50.0) == pytest.approx(200.0)
    assert R.percentile(gaps, missing, q=95.0) is None


def test_output_rate_is_the_window_s_tokens_over_its_seconds():
    steps = [NS(t0=t, t1=t + 0.5, first=f, decode=d)
             for t, f, d in ((-1.0, 3, 10), (0.0, 1, 100), (0.5, 0, 120),
                             (1.0, 2, 90))]
    ctx = NS(steps=steps, t_open=0.0, t_close=1.5)
    assert R.window_tokens(ctx) == 1 + 100 + 120 + 2 + 90
    assert R.occupancy(ctx) == pytest.approx((100 + 120 + 90) / 3)


# the kernel table of PERF.md (chip_smoke.py's phase 3 counting)
KERNEL_TABLE = [
    # (E, rows a group, C, D, F, fused, bound ms, GB)
    (8, 3, 3, 4096, 14336, True, 0.5611, 1.88),     # fused_gate_up decode
    (8, 3, 3, 14336, 4096, False, 0.2806, 0.94),    # gmm decode
    (8, 3, 3, 4096, 7168, True, 0.2806, 0.94),      # TP decode F-shard
    (16, 2, 2, 4096, 7168, True, 0.5611, 1.880),    # jamba F-shard
    (4, 3, 3, 4096, 14336, True, 0.2806, 0.940),    # E-local decode
]


@pytest.mark.parametrize("e,rows,c,d,f,fused,ms,gb", KERNEL_TABLE)
def test_launch_bound_reproduces_the_kernel_table(e, rows, c, d, f, fused,
                                                  ms, gb):
    nbytes, ops = RF.gmm_bytes_flops(e, [rows] * e, c, d, f, fused)
    assert RF.bound_s(nbytes, ops) * 1e3 == pytest.approx(ms, abs=2e-4)
    assert nbytes / 1e9 == pytest.approx(gb, abs=0.01)


def test_expert_ffn_bound_by_hand():
    d, f = 4096, 14336
    loads = [40, 0, 30, 25, 0, 60, 33, 68]     # 6 experts with rows
    nbytes, ops = RF.expert_ffn(loads, d, f, "bf16")
    assert nbytes == 6 * 3 * d * f * 2 + 256 * d * 4
    assert ops == 6 * 256 * d * f
    # bytes bound: 6 experts of 352 MB over 3.35 TB/s
    assert RF.bound_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)
    q, _ = RF.expert_ffn(loads, d, f, "int8")
    assert q == 6 * (3 * d * f + 4 * (2 * d + f)) + 256 * d * 4


def test_decode_attention_bound_by_hand():
    nbytes, ops = RF.decode_attn([100, 300], heads=32, kv_heads=8,
                                 head_dim=128)
    assert nbytes == 2 * 400 * 8 * 128 * 2 + 2 * 2 * 32 * 128 * 2
    assert ops == 4 * 400 * 32 * 128


def test_model_flops_by_hand():
    """One prefill of 4 tokens and one decode step of two rows with 6
    and 9 keys, through 2 layers of a small MoE."""
    cfg = NS(d_model=8, num_heads=2, num_kv_heads=1, resolved_head_dim=4,
             num_layers=2, vocab_size=10, moe=NS(num_experts=4, d_ff=16))
    tok = 2.0 * (8 * 4 * (2 * 2 + 2 * 1) + 8 * 4)
    assert RF.token_flops(cfg) == tok
    loads = np.array([[2, 3, 1, 2], [4, 0, 4, 0]])        # 8 = 4 tokens x 2
    call_p = NS(loads=loads, dropped=None)
    call_d = NS(loads=np.array([[1, 1, 1, 1], [2, 0, 2, 0]]), dropped=None)
    steps = [NS(t0=0.0, t1=1.0, first=1, decode=2, calls=[call_p, call_d])]
    recs = [NS(req=NS(prompt=[0] * 4), times=[1.0, 2.0]),
            NS(req=NS(prompt=[0] * 5), times=[0.5, 1.0]),
            NS(req=NS(prompt=[0] * 7), times=[0.2, 0.6, 1.0])]
    ctx = NS(cfg=cfg, stretch=steps, recs=recs)
    expert = 6.0 * 8 * 16
    prefill = 2 * (4 * tok + 4 * 10 * 2 * 4) + expert * 16 + 2 * 8 * 10
    # decode rows: prompt 5 at its token 1 (6 keys), prompt 7 at token 2
    decode = 2 * (2 * tok + 4 * (6 + 9) * 2 * 4) + expert * 8 \
        + 2 * 2 * 8 * 10
    assert R.flops(ctx) == pytest.approx(prefill + decode)
    assert R.flops(ctx, ("decode",)) == pytest.approx(decode)


def test_peaks_are_the_published_h100_sxm_figures():
    assert RF.PEAK_FLOPS["bfloat16"] == 989e12
    assert RF.HBM_BYTES_S == 3.35e12
    assert math.isclose(RF.bound_s(3.35e12, 0), 1.0)


def test_drop_shares_and_unplaced_over_the_window_s_calls():
    """Drops and routed assignments summed by phase over the calls from
    the window's opening on; a call before it, and one that reports no
    drops, left out; unplaced counts the loads of experts the tables in
    force held no replica of."""
    loads = np.array([[3, 1], [2, 2]])            # (Lm 2, E 2)
    slots = np.array([[[0], [1]], [[2], [-1]]])   # layer 1: expert 1 none

    def call(ph, d, s=None):
        return NS(phase=ph, loads=loads, slots=s,
                  dropped=None if d is None else np.array(d))
    steps = [NS(t0=0.5, first=1, calls=[call("prefill", [5, 5])]),
             NS(t0=1.0, first=1, calls=[call("prefill", [1, 0], slots),
                                        call("decode", [0, 1], slots)]),
             NS(t0=2.0, first=0, calls=[call("decode", None, slots)])]
    ctx = NS(steps=steps, t_open=1.0)
    assert H.dropped(ctx) == {"prefill": (1.0, 8.0), "decode": (1.0, 8.0)}
    assert H.unplaced(ctx) == 3 * 2
