"""The rate sweep that fixes an open-loop cell's rate: one process, one
engine set up as a run sets it up, then a window at each rate in turn
(drained before the next), each with its p95s, its backlog at the
window's close and what it completed. Not part of a benchmark run.

    python3 perfbench/sweep.py --workload <cell> --seed <n> \\
        --rates 4,6,8 --seconds <s> [--drain <s>]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--drain", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.run import one_host_thread
    one_host_thread()                          # as a benchmark run
    import torch

    from perfbench.core import harness, readers, spec
    from perfbench.core import serve as SV
    from perfbench.core import traffic as TR
    from perfbench.core import weights as W
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    cfg = spec.model_config(cell.config)
    params = W.make(cfg, args.seed, "cuda")
    system = SV.build(cfg, params, cell.cell, cell.config, False)
    tspec = TR.load(cell.entry["traffic"])
    rates = [float(r) for r in args.rates.split(",")]
    sess = SV.Session(system, TR.Generator(tspec, args.seed, cfg.vocab_size,
                                           rate=rates[0]), False)
    harness.setup(sess, cell.cell, tspec)
    print(json.dumps({"setup_s": time.perf_counter() - T_START}),
          flush=True)
    for i, rate in enumerate(rates):
        sess.gen = TR.Generator(tspec, args.seed + 1 + i, cfg.vocab_size,
                                rate=rate)
        sess.queue.clear()
        c = {**cell.cell, "drain_s": args.drain}
        t_open = time.perf_counter()
        t_open, t_close, measured = harness.window(sess, c, tspec,
                                                   args.seconds, None)
        at_close = sum(1 for r in measured
                       if r.times == [] or r.times[0] > t_close)
        ctx = harness.Context(cfg, 0.0, t_open, t_close, sess.steps, [],
                              measured, True)
        done = [r for r in measured if r.handle.finish_reason]
        row = {"rate": rate, "due": len(measured),
               "finished_in_drain": len(done),
               "waiting_at_close": at_close,
               **{k: v for k, v in readers.summary(ctx).items()
                  if k in ("ttft_ms", "itl_ms")},
               "served_s": time.perf_counter() - t_open}
        print(json.dumps(row), flush=True)
        for r in list(sess.queue):
            sess.recs.pop(r.rid, None)
        sess.queue.clear()
        while sess.sys.engine.has_work:
            sess.step()
        del ctx
    return 0


if __name__ == "__main__":
    sys.exit(main())
