"""The control on the card: the reference computed a precision below the
configuration's (float8 e4m3 weights and activations for bfloat16,
int4 rows for int8 banks), put in the program's place over the same
prompts and served tokens, must fail the cell's limit that the program
passes. Runs a short window of the cell at its own sizes; the runs
``calibrate.py`` makes on a dozen seeds are what the limits were set
from."""
from __future__ import annotations

import time

import pytest


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell runs the port's kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixtral.batch", "phi.moeless.rag"])
def test_the_control_fails_the_limit_the_program_passes(card, name):
    from perfbench.core import harness, spec
    cell = spec.load_cell(name)
    res, readings, _ = harness.run(cell, 2**31 + 101, 20.0, False,
                                   time.perf_counter(), control=True)
    limit = cell.cell["check"]["limits"]["widest_gap"]
    assert readings["program"]["widest_gap"] <= limit, readings
    assert readings["control"]["widest_gap"] > limit, readings
