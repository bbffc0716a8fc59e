"""Mean host wall of one admission over the traced stretch: solo
prefill, its control step and the runtime's apply (telemetry
engine_step_seconds{phase="prefill"})."""
from perfbench.core import readers as R


def read(ctx):
    return R.step_ms(ctx, "prefill")
