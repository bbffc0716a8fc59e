"""Mean tokens the batched step emitted per decode iteration over the
window (admissions' first tokens left out)."""
from perfbench.core import readers as R


def read(ctx):
    return R.occupancy(ctx)
