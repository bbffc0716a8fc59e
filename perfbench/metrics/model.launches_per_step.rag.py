"""Device kernels in the traced stretch over the engine iterations in
it."""
from perfbench.core import readers as R


def read(ctx):
    return R.launches(ctx)
