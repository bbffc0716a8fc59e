"""Reading a ``torch.profiler`` trace of a stretch of the traced window:
the device's kernels and copies with their intervals, and the harness's
own host spans (``pb:<name>``), on the profiler's one clock."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def _on_device(evt) -> bool:
    return "cuda" in str(getattr(evt, "device_type", "")).lower()


@dataclass
class Trace:
    """Device operations [(name, start_us, end_us)] and harness spans
    [(name, start_us, end_us)] of one profiled stretch, and the stretch
    [t0_us, t1_us]: from the first harness span's start to the last
    one's end. The kernels the harness's probe launched (from host ops
    under its span ``probe``) are counted apart: `probe_kernels`, and
    their device time `probe_us`; the readings of the program leave
    them out."""
    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0
    probe_kernels: int = 0
    probe_us: float = 0.0
    stop_s: float = 0.0      # the profiler's stop, in the window
    read_s: float = 0.0      # reading its events, after the window

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self, names=None) -> list:
        """Device kernels (copies and fills left out), or only those whose
        name holds one of `names`."""
        ks = [o for o in self.ops
              if not o[0].startswith(("Memcpy", "Memset"))]
        if names is None:
            return ks
        return [o for o in ks if any(n in o[0] for n in names)]

    def busy(self) -> list:
        """The union of the device operations' intervals, clipped to the
        stretch: [(start_us, end_us)]."""
        out = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        """Device busy seconds of the program: the union of operations
        less the probe's kernels (on the one stream, none overlaps)."""
        return (sum(b - a for a, b in self.busy()) - self.probe_us) / 1e6

    def idle_gaps(self) -> list:
        """[(start_us, end_us)] of the stretch with no device operation."""
        gaps, t = [], self.t0
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost harness span open at t (``outside``: none)."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "outside"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing, each [name, seconds], at most `top`."""
        by_op: dict[str, float] = {}
        for name, a, b in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
        by_host: dict[str, float] = {}
        for a, b in self.idle_gaps():
            name = self.host_at((a + b) / 2)
            by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
        srt = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in srt],
                "idle_gaps": [[k, v] for k, v in sorted(
                    by_host.items(), key=lambda kv: -kv[1])[:top]]}


class Profiler:
    """Start and stop ``torch.profiler`` around a stretch of steps."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()

    def open(self):
        """Mark where the stretch opens: what came before is left out."""
        with torch.profiler.record_function("pb:open"):
            pass

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def read(self) -> Trace:
        """The stopped profiler's events as a ``Trace``."""
        tr = Trace()
        launched = []           # (host op start, a kernel's device us)
        for e in self.prof.events():
            name = e.name
            a, b = float(e.time_range.start), float(e.time_range.end)
            if name.startswith("pb:"):
                if not _on_device(e):
                    tr.spans.append((name[3:], a, b))
            elif _on_device(e):
                if b > a:
                    tr.ops.append((name, a, b))
            else:               # the kernels a host op launched
                launched += [(a, float(k.duration))
                             for k in getattr(e, "kernels", ())]
        opened = [a for name, a, _ in tr.spans if name == "open"]
        if opened:
            t0 = opened[0]
            tr.spans = [s for s in tr.spans if s[1] >= t0]
            tr.ops = [o for o in tr.ops if o[1] >= t0]
            launched = [x for x in launched if x[0] >= t0]
        probe = [(a, b) for n, a, b in tr.spans if n == "probe"]
        mine = [us for t, us in launched
                if any(p <= t <= q for p, q in probe)]
        tr.probe_kernels, tr.probe_us = len(mine), sum(mine)
        if tr.spans:
            tr.t0 = min(s[1] for s in tr.spans)
            tr.t1 = max(s[2] for s in tr.spans)
        return tr
