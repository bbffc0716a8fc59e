"""95th percentile of due-to-first-token over every request due in the
window (host clock); an unfinished request is missing, above every
finished one."""
from perfbench.core import readers as R


def read(ctx):
    return R.percentile(*R.ttft_ms(ctx), q=95.0)
