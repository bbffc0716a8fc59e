"""Chrome trace-event tracer: spans and instant events, serialised as
Trace Event Format JSON that loads directly into Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Tracks are named lanes (``"engine"``, ``"moeless/req3"``, ``"router"``)
mapped to stable ``tid`` values with ``thread_name`` metadata so the
viewer shows readable lane names. Timestamps are SECONDS in the
caller's timeline — the serving stack records everything against the
(modeled) serving clock, so a trace of a deterministic replay is itself
deterministic — converted to the format's microseconds on emit.

Event kinds:
  * ``span(track, name, t0, t1)``   — a complete event (``ph: "X"``);
  * ``instant(track, name, t)``     — an instant event (``ph: "i"``);
  * ``counter(track, name, t, **v)``— a counter event (``ph: "C"``,
    rendered as a stacked area chart in the viewer).

Thread-safe (one lock around the event list); ``write`` dumps
``{"traceEvents": [...], "displayTimeUnit": "ms"}``.
"""
from __future__ import annotations

import json
import threading


class Tracer:
    """Collects trace events in memory; write once at the end of a run
    (serving traces are small — thousands of events, not millions)."""

    def __init__(self, process_name: str = "repro-serving"):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tids: dict[str, int] = {}
        self._meta = [{"name": "process_name", "ph": "M", "pid": 0,
                      "tid": 0, "args": {"name": process_name}}]

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
            self._meta.append({"name": "thread_name", "ph": "M",
                               "pid": 0, "tid": tid,
                               "args": {"name": track}})
        return tid

    def span(self, track: str, name: str, t0: float, t1: float,
             args: dict | None = None, cat: str = "serving") -> None:
        """One complete span on `track`, [t0, t1] in seconds."""
        with self._lock:
            ev = {"name": name, "cat": cat, "ph": "X", "pid": 0,
                  "tid": self._tid(track), "ts": t0 * 1e6,
                  "dur": max(t1 - t0, 0.0) * 1e6}
            if args:
                ev["args"] = args
            self._events.append(ev)

    def instant(self, track: str, name: str, t: float,
                args: dict | None = None, cat: str = "serving") -> None:
        """One instant event at `t` seconds (thread-scoped)."""
        with self._lock:
            ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
                  "pid": 0, "tid": self._tid(track), "ts": t * 1e6}
            if args:
                ev["args"] = args
            self._events.append(ev)

    def counter(self, track: str, name: str, t: float, **values) -> None:
        """One counter sample (the viewer draws a stacked area chart)."""
        with self._lock:
            self._events.append(
                {"name": name, "cat": "serving", "ph": "C", "pid": 0,
                 "tid": self._tid(track), "ts": t * 1e6,
                 "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------------- dump

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_obj(self) -> dict:
        with self._lock:
            return {"traceEvents": self._meta + self._events,
                    "displayTimeUnit": "ms"}

    def write(self, path: str) -> int:
        """Dump the trace JSON to `path`; returns the event count."""
        obj = self.to_obj()
        with open(path, "w") as f:
            json.dump(obj, f)
        return len(obj["traceEvents"])
