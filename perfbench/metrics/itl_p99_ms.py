"""99th percentile of every gap between consecutive tokens of the
requests due in the window (host clock); an unfinished request's missing
gaps lie above every gap. The 99th, not the 95th: a gap that holds a
solo prefill is as long as that prefill's power-of-two bucket, so the
gaps form a few steps, and the 95th falls on the step between the 4096
and 8192 buckets (two runs of one seed read 138 and 189 ms); the 99th
lies inside the 8192 step, with some 90 gaps beyond it."""
from perfbench.core import readers as R


def read(ctx):
    return R.percentile(*R.itl_ms(ctx), q=99.0)
