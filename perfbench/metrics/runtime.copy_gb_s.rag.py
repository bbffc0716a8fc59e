"""Bytes the expert runtime wrote into its slot banks over the traced
stretch (telemetry runtime_bytes_moved_total) over its seconds, GB/s."""
from perfbench.core import readers as R


def read(ctx):
    return R.copy_gb_s(ctx)
