"""The benchmark of the port on NVIDIA GPUs: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell's model with weights made from the seed, warms up and
serves the cell's traffic (set-up), measures for --seconds, checks what
it served against the float32 reference, and prints the run's result as
the last line of standard output: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics read from a profiled
stretch of the window. The numbers compared by the check are the last
lines of standard error, and the result's last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the JAX package and its libraries: none may be loaded by a run
BANNED = {"jax", "jaxlib", "flax", "repro"}


def loaded_banned() -> list:
    """Banned top-level module names in this process, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def one_host_thread() -> None:
    """One host thread for the CPU side of the program, set before torch
    is first imported: the decode step is host-bound, and a pool of
    spinning threads on the machine's few cores makes it vary."""
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    one_host_thread()
    import torch

    from perfbench.core import harness, readers, spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"perfbench: {args.workload} needs {cell.entry['chips']} "
              "CUDA device(s); none usable here", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (fails where the port is absent)
    result, readings, ctx = harness.run(
        cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = loaded_banned()
    if bad:
        print(f"perfbench: modules of the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, (d, n) in harness.dropped(ctx).items():
        print(f"dropped assignments, {k}: {d:.0f} of {n:.0f}",
              file=sys.stderr)
    if ctx.trace is not None:
        print("probe: " + json.dumps(readers.probe(ctx)), file=sys.stderr)
        print(f"trace: profiler stop {ctx.trace.stop_s:.3f} s in the window,"
              f" events read {ctx.trace.read_s:.3f} s after it",
              file=sys.stderr)
    print("window: " + json.dumps(readers.summary(ctx)), file=sys.stderr)
    print(f"card: {card()}", file=sys.stderr)
    print("reference: " + json.dumps(readings), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
