"""Sum of decode attention's bound over the traced stretch's decode
steps and layers (K/V at each live slot's length, q and out) over the
device time of the decode attention kernels, in percent."""
from perfbench.core import readers as R


def read(ctx):
    return R.roofline(ctx, "decode_attn", R.attn_bound_s)
