"""A cell at the smoke sizes of its architecture, run on the CPU through
the harness's own path (the check included), for the tests."""
from __future__ import annotations

import dataclasses
import time

from perfbench.core import harness, spec

SMALL = {
    "mixtral.batch": dict(
        slots=8, max_len=320, setup={"finished": 8},
        traffic_override={"prompt": {"median": 48, "sigma": 0.9, "min": 8,
                            "max": 128},
                 "output": {"median": 24, "sigma": 0.8, "min": 4,
                            "max": 128},
                 "min_queued": 16}),
    "phi.moeless.rag": dict(
        slots=8, max_len=320, rate=20.0, setup={"burst_s": 1.0},
        traffic_override={"prompt": {"median": 64, "sigma": 0.9, "min": 16,
                            "max": 256},
                 "output": {"median": 16, "sigma": 0.8, "min": 4,
                            "max": 48}}),
}


def small_cell(name: str):
    cell = spec.load_cell(name)
    return dataclasses.replace(cell, cell={**cell.cell, **SMALL[name]})


def run(name: str, seed: int = 5, seconds: float = 3.0, fault=None,
        control: bool = False, limits=None):
    """(result, readings, context) of one smoke run in float32 with the
    plain kernels."""
    return harness.run(small_cell(name), seed, seconds, False,
                       time.perf_counter(), device="cpu", smoke=True,
                       fault=fault, control=control, limits=limits)
