"""Process-wide metrics registry: counters, gauges, and fixed-bucket
histograms with labeled families, rendered either as Prometheus text
exposition (the gateway's ``GET /metrics``) or as a flat dict (tests,
``benchmarks/serving_bench.py`` deterministic leaves).

Zero dependencies: this is a small faithful subset of the Prometheus
client data model —

  * a **family** is a named metric with a declared label schema
    (``registry.counter("scheduler_admitted_total", labels=())``);
  * a **series** (child) is one label assignment of a family
    (``fam.labels(layer="3")``), cached so the hot path pays one dict
    lookup;
  * exposition follows the text format 0.0.4: ``# HELP`` / ``# TYPE``
    headers, ``name{label="v"} value`` samples, histograms as
    cumulative ``_bucket{le=...}`` series plus ``_sum`` / ``_count``.

Thread safety: one registry lock guards family creation and every
series mutation — the gateway mutates from N engine step threads while
the asyncio thread scrapes. Mutations are a float add under a lock,
cheap at the per-iteration granularity everything here is recorded at.

Label cardinality is bounded (``max_series`` per family, default 1024):
an instrumentation bug that interpolates an unbounded value into a
label (request ids, timestamps) raises instead of silently eating
memory on a long-lived gateway.
"""
from __future__ import annotations

import math
import threading

# shared fixed bucket boundaries (seconds) for every latency histogram:
# 100us .. 10s covers modeled smoke-clock iterations and real steps
TIME_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats shortest."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _label_str(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Family:
    """One named metric family with a declared label schema."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: tuple, max_series: int):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.max_series = max_series
        self._series: dict[tuple, object] = {}

    def _child(self, values: tuple):
        raise NotImplementedError

    def labels(self, **kv):
        """The series for one label assignment (cached). Label names
        must match the family's declared schema exactly."""
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} do not match declared "
                f"labelnames {sorted(self.labelnames)}")
        values = tuple(str(kv[n]) for n in self.labelnames)
        with self.registry._lock:
            s = self._series.get(values)
            if s is None:
                if len(self._series) >= self.max_series:
                    raise ValueError(
                        f"{self.name}: label cardinality exceeded "
                        f"{self.max_series} series (unbounded label "
                        f"value?) — adding {values!r}")
                s = self._series[values] = self._child(values)
            return s

    def _default(self):
        """The label-less series of a label-less family."""
        if self.labelnames:
            raise ValueError(f"{self.name} declares labels "
                             f"{self.labelnames}; use .labels(...)")
        return self.labels()

    def samples(self) -> list[tuple[str, str, float]]:
        """[(suffix, labelstr, value)] for exposition, stable order."""
        out = []
        for values in sorted(self._series):
            out.extend(self._series[values].samples(
                self.labelnames, values))
        return out


class _Value:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def samples(self, names, values):
        return [("", _label_str(names, values), self.value)]


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class _GaugeChild(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock, buckets):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)     # + the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def samples(self, names, values):
        out, cum = [], 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(("_bucket",
                        _label_str(names, values, f'le="{_fmt(b)}"'), cum))
        out.append(("_bucket",
                    _label_str(names, values, 'le="+Inf"'), self.count))
        out.append(("_sum", _label_str(names, values), self.sum))
        out.append(("_count", _label_str(names, values), self.count))
        return out


class CounterFamily(_Family):
    kind = "counter"

    def _child(self, values):
        return _CounterChild(self.registry._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)


class GaugeFamily(_Family):
    kind = "gauge"

    def _child(self, values):
        return _GaugeChild(self.registry._lock)

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames, max_series,
                 buckets):
        super().__init__(registry, name, help, labelnames, max_series)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")

    def _child(self, values):
        return _HistogramChild(self.registry._lock, self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)


class MetricsRegistry:
    """Named metric families; the process-wide telemetry spine."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name, help, labels, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls \
                        or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered as "
                        f"{cls.kind}{tuple(labels)} but exists as "
                        f"{fam.kind}{fam.labelnames}")
                return fam
            fam = cls(self, name, help, tuple(labels), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels=(),
                max_series: int = 1024) -> CounterFamily:
        return self._register(CounterFamily, name, help, labels,
                              max_series=max_series)

    def gauge(self, name: str, help: str = "", labels=(),
              max_series: int = 1024) -> GaugeFamily:
        return self._register(GaugeFamily, name, help, labels,
                              max_series=max_series)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=TIME_BUCKETS,
                  max_series: int = 1024) -> HistogramFamily:
        return self._register(HistogramFamily, name, help, labels,
                              max_series=max_series, buckets=buckets)

    # ------------------------------------------------------- rendering

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4 over every family, families in
        name order, series in label order — byte-stable for a fixed
        sequence of recordings (the golden-file contract)."""
        lines = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for suffix, labelstr, value in fam.samples():
                    lines.append(f"{name}{suffix}{labelstr} "
                                 f"{_fmt(value)}")
        return "\n".join(lines) + "\n"

    def as_dict(self) -> dict[str, float]:
        """Flat ``{series_name: value}`` snapshot — histogram series
        expand to ``_bucket{le=...}`` / ``_sum`` / ``_count`` exactly
        like the exposition, so tests and benches read one schema."""
        out = {}
        with self._lock:
            for name in sorted(self._families):
                for suffix, labelstr, value in \
                        self._families[name].samples():
                    out[f"{name}{suffix}{labelstr}"] = float(value)
        return out
