"""Lock-cheap metrics registry: counters, gauges, log-bucketed histograms.

The service and engine need numbers that are cheap enough to update on the
per-chunk hot path (a dict update under a short lock — no I/O, no string
formatting) and structured enough to answer operator questions ("which
tenant is burning movers", "what is the p99 verify lag on hop 2"). The
shapes are deliberately Prometheus-like without the dependency:

  * a **family** is a named metric plus a label schema, e.g.
    ``chunks_total{tenant, pipeline}``;
  * each distinct label-value tuple owns one **series** (a counter cell, a
    gauge cell, or a histogram's bucket array);
  * ``snapshot()`` returns a plain nested dict (JSON-ready), and
    ``delta(a, b)`` subtracts two snapshots so benchmarks can report "what
    this run added" even against a long-lived registry.

Histograms use base-2 **log buckets**: value v lands in bucket
``ceil(log2(v / scale))`` clamped to [0, nbuckets). Durations spanning six
orders of magnitude (10 µs checksum ops to 100 s outage waits) stay
resolvable with ~40 buckets, and bucket edges are exact powers of two so
two processes bucket identically.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Tuple

LabelValues = Tuple[str, ...]


class _Family:
    """Shared plumbing: label schema + per-series cells behind one lock."""

    kind = "abstract"

    def __init__(self, name: str, help: str, labels: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[LabelValues, object] = {}

    def _key(self, labelvalues: Dict[str, object] | None) -> LabelValues:
        lv = labelvalues or {}
        extra = set(lv) - set(self.labels)
        if extra:
            raise ValueError(
                f"{self.name}: unknown labels {sorted(extra)} "
                f"(schema is {list(self.labels)})")
        return tuple(str(lv.get(name, "")) for name in self.labels)

    def series(self):
        with self._lock:
            return dict(self._series)

    def value(self, **labelvalues):
        """The series cell for one label tuple (0.0/None when absent)."""
        key = self._key(labelvalues)
        with self._lock:
            cell = self._series.get(key)
        if isinstance(cell, dict):
            return dict(cell)
        return 0.0 if cell is None else cell


class Counter(_Family):
    """Monotone accumulator; ``inc`` may add any non-negative amount."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labelvalues) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(_Family):
    """Point-in-time value; settable and adjustable."""

    kind = "gauge"

    def set(self, value: float, **labelvalues) -> None:
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = float(value)

    def add(self, amount: float, **labelvalues) -> None:
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Histogram(_Family):
    """Base-2 log-bucketed distribution (see module docstring).

    Bucket i covers ``(scale * 2**(i-1), scale * 2**i]``; bucket 0 also
    absorbs everything <= scale, the last bucket absorbs the overflow tail.
    """

    kind = "histogram"

    def __init__(self, name, help, labels, *, scale: float = 1e-6,
                 nbuckets: int = 40):
        super().__init__(name, help, labels)
        if scale <= 0 or nbuckets < 2:
            raise ValueError("scale must be > 0 and nbuckets >= 2")
        self.scale = scale
        self.nbuckets = nbuckets

    def bucket_index(self, value: float) -> int:
        if value <= self.scale:
            return 0
        idx = int(math.ceil(math.log2(value / self.scale)))
        return min(max(idx, 0), self.nbuckets - 1)

    def bucket_upper(self, index: int) -> float:
        """Inclusive upper edge of bucket ``index`` (inf for the overflow)."""
        if index >= self.nbuckets - 1:
            return math.inf
        return self.scale * (2.0 ** index)

    def observe(self, value: float, **labelvalues) -> None:
        key = self._key(labelvalues)
        idx = self.bucket_index(value)
        with self._lock:
            cell = self._series.get(key)
            if cell is None:
                cell = {"count": 0, "sum": 0.0,
                        "buckets": [0] * self.nbuckets}
                self._series[key] = cell
            cell["count"] += 1
            cell["sum"] += value
            cell["buckets"][idx] += 1

    def quantile(self, q: float, **labelvalues) -> float:
        """Upper bucket edge at quantile ``q`` (0 if the series is empty)."""
        key = self._key(labelvalues)
        with self._lock:
            cell = self._series.get(key)
            if not cell or not cell["count"]:
                return 0.0
            cum, edges = [], []
            run = 0
            for i, n in enumerate(cell["buckets"]):
                run += n
                cum.append(run)
                edges.append(self.bucket_upper(i))
            rank = q * cell["count"]
        i = bisect.bisect_left(cum, rank)
        return edges[min(i, len(edges) - 1)]


class Registry:
    """Named families; the process-global instance is ``REGISTRY``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name, help, labels, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labels != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"kind or label schema")
                return fam
            fam = cls(name, help, tuple(labels), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = (), *, scale: float = 1e-6,
                  nbuckets: int = 40) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              scale=scale, nbuckets=nbuckets)

    def snapshot(self) -> dict:
        """JSON-ready view: {family: {kind, labels, series: {key: value}}}.

        Series keys are the label values joined with ``,`` (label names are
        in the family header); histogram cells copy their bucket arrays so
        the snapshot is immune to later updates.
        """
        out = {}
        with self._lock:
            fams = dict(self._families)
        for name, fam in sorted(fams.items()):
            series = {}
            for key, cell in fam.series().items():
                skey = ",".join(key)
                if isinstance(cell, dict):
                    series[skey] = {"count": cell["count"],
                                    "sum": cell["sum"],
                                    "buckets": list(cell["buckets"])}
                else:
                    series[skey] = cell
            out[name] = {"kind": fam.kind, "labels": list(fam.labels),
                        "series": series}
        return out

    def clear(self) -> None:
        """Drop all families (tests and benchmark isolation)."""
        with self._lock:
            self._families.clear()


def delta(before: dict, after: dict) -> dict:
    """What happened between two snapshots.

    Counters and histogram counts/sums/buckets subtract; gauges take the
    ``after`` value (a gauge is a level, not a flow). Series or families
    absent from ``before`` count from zero.
    """
    out = {}
    for name, fam in after.items():
        prev = before.get(name, {"series": {}})
        series = {}
        for key, cell in fam["series"].items():
            old = prev["series"].get(key)
            if fam["kind"] == "gauge":
                series[key] = cell
            elif isinstance(cell, dict):
                if old is None:
                    old = {"count": 0, "sum": 0.0,
                           "buckets": [0] * len(cell["buckets"])}
                series[key] = {
                    "count": cell["count"] - old["count"],
                    "sum": cell["sum"] - old["sum"],
                    "buckets": [a - b for a, b in
                                zip(cell["buckets"], old["buckets"])],
                }
            else:
                series[key] = cell - (old or 0.0)
        out[name] = {"kind": fam["kind"], "labels": fam["labels"],
                    "series": series}
    return out


REGISTRY = Registry()
