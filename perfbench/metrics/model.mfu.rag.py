"""Useful model operations of the traced stretch (prompt and generated
tokens with their contexts, kept expert rows, the head where its logits
are used) over the stretch's seconds x 989 TFLOP/s, in percent."""
from perfbench.core import readers as R


def read(ctx):
    return R.mfu(ctx)
