"""Dependency-free Prometheus-style metrics (``repro_torch.obs`` pillar 2).

A tiny in-process registry of counters, gauges, and histograms with
explicit buckets, rendered in the Prometheus text exposition format
(version 0.0.4) — what ``GET /metrics`` serves.  No client library is
involved: the repo's container must not grow dependencies, and the subset
needed here (no summaries, no exemplars, single process) is ~200 lines.

Semantics follow the Prometheus data model:

  * ``Counter`` — monotonically increasing; rendered with a ``_total``
    suffix if the declared name does not already end in one.
  * ``Gauge`` — a value that goes up and down (queue depth, free pages).
  * ``Histogram`` — observations bucketed by ``le`` upper bounds; the
    rendered series are **cumulative** ``<name>_bucket{le="..."}`` counts
    ending in ``le="+Inf"``, plus ``<name>_sum`` and ``<name>_count``
    (the invariants ``bucket[+Inf] == count`` and monotone buckets are
    pinned by ``tests/test_torch_obs.py``).

Labels: a metric is declared with a fixed tuple of label *names*; each
observation addresses a child by label *values* (``c.inc(1, reason="x")``).
Everything is plain dict arithmetic — no locks, because the serving stack
mutates metrics only from the scheduler loop (single-threaded by the
AsyncSliceServer invariant) and HTTP rendering reads are tolerant of a
concurrent increment.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS", "DEFAULT_TOKEN_BUCKETS"]

#: latency-style buckets (seconds): sub-ms to minutes, roughly 1-2-5
DEFAULT_TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                        120.0, 300.0)
#: token-count buckets (powers of two up to 8k)
DEFAULT_TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                         2048, 4096, 8192)

_LabelKey = Tuple[str, ...]


def _format_value(v: float) -> str:
    """Prometheus sample formatting: integral values without the trailing
    ``.0``, non-finite as +Inf/-Inf/NaN."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _render_labels(names: Sequence[str], values: _LabelKey,
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label(str(v))}"'
             for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """Shared declaration state (name, help, label names)."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: Dict[str, str]) -> _LabelKey:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def render(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[_LabelKey, float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc({amount}))")
        k = self._key(labels)
        self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(self._key(labels), 0.0)

    @property
    def sample_name(self) -> str:
        return (self.name if self.name.endswith("_total")
                else self.name + "_total")

    def render(self) -> List[str]:
        out = [f"# HELP {self.sample_name} {self.help}",
               f"# TYPE {self.sample_name} counter"]
        for k in sorted(self._values):
            out.append(f"{self.sample_name}"
                       f"{_render_labels(self.labelnames, k)} "
                       f"{_format_value(self._values[k])}")
        return out


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[_LabelKey, float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def set(self, value: float, **labels: str) -> None:
        self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        k = self._key(labels)
        self._values[k] = self._values.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for k in sorted(self._values):
            out.append(f"{self.name}{_render_labels(self.labelnames, k)} "
                       f"{_format_value(self._values[k])}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"{name}: buckets must be a non-empty "
                             f"strictly increasing sequence, got {buckets}")
        self.buckets = bs  # upper bounds, +Inf implicit
        # per child: [per-bucket counts..., +Inf count], sum
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        if not self.labelnames:
            self._child(())

    def _child(self, k: _LabelKey) -> List[int]:
        c = self._counts.get(k)
        if c is None:
            c = self._counts[k] = [0] * (len(self.buckets) + 1)
            self._sums[k] = 0.0
        return c

    def observe(self, value: float, **labels: str) -> None:
        k = self._key(labels)
        c = self._child(k)
        self._sums[k] += value
        for i, b in enumerate(self.buckets):
            if value <= b:
                c[i] += 1
                return
        c[-1] += 1  # above every finite bound: +Inf only

    def count(self, **labels: str) -> int:
        k = self._key(labels)
        return sum(self._counts.get(k, ()))

    def sum(self, **labels: str) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        for k in sorted(self._counts):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[k][i]
                out.append(
                    f"{self.name}_bucket"
                    f"{_render_labels(self.labelnames, k, ('le', _format_value(b)))} "
                    f"{cum}")
            cum += self._counts[k][-1]
            out.append(f"{self.name}_bucket"
                       f"{_render_labels(self.labelnames, k, ('le', '+Inf'))} "
                       f"{cum}")
            out.append(f"{self.name}_sum"
                       f"{_render_labels(self.labelnames, k)} "
                       f"{_format_value(self._sums[k])}")
            out.append(f"{self.name}_count"
                       f"{_render_labels(self.labelnames, k)} {cum}")
        return out


class MetricsRegistry:
    """Declaration + rendering home for one process's metrics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, m: _Metric) -> _Metric:
        prev = self._metrics.get(m.name)
        if prev is not None:
            if type(prev) is not type(m) \
                    or prev.labelnames != m.labelnames:
                raise ValueError(f"metric {m.name!r} re-registered with a "
                                 f"different type or labels")
            return prev  # idempotent re-declaration
        self._metrics[m.name] = m
        return m

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))  # type: ignore[return-value]

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))  # type: ignore[return-value]

    def histogram(self, name: str, help: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._register(Histogram(name, help, buckets, labelnames))  # type: ignore[return-value]

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def __iter__(self) -> Iterable[_Metric]:
        return iter(self._metrics.values())

    def render(self) -> str:
        """The full Prometheus text exposition (trailing newline included,
        as the format requires)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"
