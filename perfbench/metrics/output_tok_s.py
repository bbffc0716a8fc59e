"""Output tokens the window's steps delivered over the window's seconds
(host clock)."""
from perfbench.core import readers as R


def read(ctx):
    return R.window_tokens(ctx) / (ctx.t_close - ctx.t_open)
