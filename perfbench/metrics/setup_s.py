"""Process start to window start: imports, weights, kernel load, warm-up
(host clock)."""
from perfbench.core import readers as R


def read(ctx):
    return ctx.setup_s
