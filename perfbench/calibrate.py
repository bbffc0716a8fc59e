"""Readings that the check's limits are set from: runs of one cell on
many seeds in one process, each with the program's reading and the
control's (the reference computed a precision below the configuration's
over the same prompts and served tokens), or with a fault planted in the
program (``--fault``). Not part of a benchmark run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control 1] [--fault one_replica] \\
        [--out <file.jsonl>]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def one_replica(system) -> None:
    """A planner that places fewer replicas: MoEless's scaler held to
    one replica an expert (its slot cap set to the number of experts)."""
    system.control.bal.mem_cap_slots = system.cfg.moe.num_experts


FAULTS = {"one_replica": one_replica}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.run import one_host_thread
    one_host_thread()                          # as a benchmark run
    import torch

    from perfbench.core import harness, spec
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    t0 = T_START
    for seed in [int(s) for s in args.seeds.split(",")]:
        res, readings, ctx = harness.run(
            cell, seed, args.seconds, False, t0,
            fault=FAULTS.get(args.fault), control=bool(args.control))
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault,
                "readings": readings, "drops": harness.dropped(ctx),
                "metrics": res["metrics"], "checks": res["checks"],
                "attempted": res["attempted"], "failed": res["failed"],
                "peak": res["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
