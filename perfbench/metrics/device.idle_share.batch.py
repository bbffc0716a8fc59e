"""Share of the traced stretch with no operation on the device, in
percent."""
from perfbench.core import readers as R


def read(ctx):
    return R.idle_share(ctx)
