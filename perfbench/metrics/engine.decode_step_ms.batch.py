"""Mean host wall of the engine's batched decode iteration over the
traced stretch (telemetry engine_step_seconds{phase="decode"} sum over
count)."""
from perfbench.core import readers as R


def read(ctx):
    return R.step_ms(ctx, "decode")
