"""What the harness and the reference load: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared whole:
``repro_torch`` is the port), and nothing of the port in the
reference."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_names(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            src=str(ROOT / "src"),
                                            body=body)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_harness_run_loads_nothing_of_the_jax_package():
    names = _top_names(
        "from perfbench.tests import _smoke\n"
        "from perfbench import run\n"
        "_smoke.run('mixtral.batch', seconds=1.0)")
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    names = _top_names(
        "from perfbench.reference import moe_decoder\n"
        "from perfbench.core import check")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_run_refuses_without_a_card_and_prints_no_result():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mixtral.batch",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_banned_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    for name in ("repro", "jax", "jaxlib", "flax"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch", sys)
    monkeypatch.setitem(sys.modules, "reprox.y", sys)
    assert run.loaded_banned() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.loaded_banned() == ["jax"]
