"""Minimal Prometheus-style metrics registry with text exposition.

Reference counterpart: the prometheus/client_golang series registered across
scheduler (13+4 placement), allocator (8), and service (7) — catalog in
doc/prometheus-metrics-exposed.md. This registry provides the instrument
kinds the reference uses (Counter, Gauge/GaugeFunc, Summary) plus a
bucketed Histogram (the reference has none — its latency series are all
summaries, which can't answer "what fraction of rescheds finished under
100 ms"), and renders the standard text format for a `/metrics` endpoint,
without a client-library dependency.

Thread-safety contract: every read and write of an instrument's shared
dicts holds the instrument's lock — scrapes run on the REST server's
threads concurrently with scheduler/daemon increments.
"""

from __future__ import annotations

import bisect
import contextlib
import fractions
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@contextlib.contextmanager
def timed(instrument, **labels: str):
    """Observe the wall-clock duration of a block into any instrument with
    an observe() method (Summary or Histogram)."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        instrument.observe(time.monotonic() - t0, **labels)


class Counter:
    def __init__(self, name: str, help_: str, label_names: Tuple[str, ...] = (),
                 const_labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.const_labels = dict(const_labels or {})
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            values = dict(self._values) or {(): 0.0} if not self.label_names else dict(self._values)
        for key, v in values.items():
            lines.append(f"{self.name}{_merge_labels(self.const_labels, self.label_names, key)} {v}")
        return lines


class Gauge:
    """Settable gauge; pass `fn` for a GaugeFunc evaluated at scrape time
    (the reference uses GaugeFuncs over its locked maps, metrics.go:99+).
    With `label_names`, one series per label tuple (e.g. per TPU device)."""

    def __init__(self, name: str, help_: str,
                 fn: Optional[Callable[[], float]] = None,
                 label_names: Tuple[str, ...] = (),
                 const_labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.const_labels = dict(const_labels or {})
        self._fn = fn
        self._value = 0.0
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, v: float, **labels: str) -> None:
        if self.label_names:
            key = tuple(labels.get(n, "") for n in self.label_names)
            with self._lock:
                self._values[key] = v
        else:
            with self._lock:
                self._value = v

    def value(self, **labels: str) -> float:
        if self.label_names:
            key = tuple(labels.get(n, "") for n in self.label_names)
            with self._lock:
                return self._values.get(key, 0.0)
        if self._fn is not None:
            return self._fn()
        with self._lock:
            return self._value

    def clear(self) -> None:
        """Drop all labeled series (for full-rebuild collectors)."""
        with self._lock:
            self._values.clear()

    def remove(self, **labels: str) -> None:
        """Drop one labeled series (for per-entity gauges whose entity
        retired — a per-job series left forever is a cardinality
        leak)."""
        if not self.label_names:
            return
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values.pop(key, None)

    def set_all(self, values: Dict[Tuple[str, ...], float]) -> None:
        """Atomically replace every labeled series (keys are label tuples
        in label_names order) — a concurrent scrape sees either the old
        or the new complete set, never a partially-cleared one."""
        with self._lock:
            self._values = dict(values)

    def collect(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        if self.label_names:
            with self._lock:
                for key, v in self._values.items():
                    lines.append(
                        f"{self.name}{_merge_labels(self.const_labels, self.label_names, key)} {v}")
        else:
            lines.append(
                f"{self.name}{_merge_labels(self.const_labels, (), ())} "
                f"{self.value()}")
        return lines


class Summary:
    """Count/sum summary (quantile-free, like an untimed reference Summary)."""

    def __init__(self, name: str, help_: str, label_names: Tuple[str, ...] = (),
                 const_labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.const_labels = dict(const_labels or {})
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._count: Dict[Tuple[str, ...], int] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, **labels: str) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._sum[key] = self._sum.get(key, 0.0) + v
            self._count[key] = self._count.get(key, 0) + 1

    def count(self, **labels: str) -> int:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._count.get(key, 0)

    def mean(self, **labels: str) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            # Sum and count must come from the same locked snapshot, or a
            # concurrent observe between the two reads skews the mean.
            c = self._count.get(key, 0)
            return self._sum.get(key, 0.0) / c if c else 0.0

    def collect(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} summary"]
        with self._lock:
            for key in self._count:
                labels = _merge_labels(self.const_labels, self.label_names, key)
                lines.append(f"{self.name}_sum{labels} {self._sum[key]}")
                lines.append(f"{self.name}_count{labels} {self._count[key]}")
        return lines


# Control-plane latencies span sub-millisecond (in-process allocation on a
# small queue) to minutes (a cold resize waiting out a checkpoint drain).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0, 600.0)


class Histogram:
    """Cumulative-bucket histogram in the Prometheus text format:
    `<name>_bucket{le="..."}` per bound plus `le="+Inf"`, and the usual
    `_sum`/`_count`. Buckets are fixed at construction (exposition
    requires every series of a family to share them)."""

    def __init__(self, name: str, help_: str, label_names: Tuple[str, ...] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 const_labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.const_labels = dict(const_labels or {})
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # per label tuple: [count per finite bucket] (non-cumulative in
        # memory; cumulated at collect time), sum, total count
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._total: Dict[Tuple[str, ...], int] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, **labels: str) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        idx = bisect.bisect_left(self.buckets, v)  # first bound >= v
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * len(self.buckets)
            if idx < len(self.buckets):
                self._counts[key][idx] += 1
            self._sum[key] = self._sum.get(key, 0.0) + v
            self._total[key] = self._total.get(key, 0) + 1

    def count(self, **labels: str) -> int:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._total.get(key, 0)

    def bucket_counts(self, **labels: str) -> Dict[float, int]:
        """Cumulative count per finite bound (observability/test helper)."""
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            per = list(self._counts.get(key, [0] * len(self.buckets)))
        out, cum = {}, 0
        for bound, c in zip(self.buckets, per):
            cum += c
            out[bound] = cum
        return out

    @staticmethod
    def _le(bound: float) -> str:
        # Prometheus renders integral bounds without a trailing .0
        return str(int(bound)) if float(bound).is_integer() else repr(bound)

    def collect(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            snapshot = {key: (list(per), self._sum.get(key, 0.0),
                              self._total.get(key, 0))
                        for key, per in self._counts.items()}
        for key, (per, total_sum, total) in snapshot.items():
            cum = 0
            for bound, c in zip(self.buckets, per):
                cum += c
                labels = _merge_labels(
                    self.const_labels, self.label_names + ("le",),
                    key + (self._le(bound),))
                lines.append(f"{self.name}_bucket{labels} {cum}")
            inf_labels = _merge_labels(
                self.const_labels, self.label_names + ("le",), key + ("+Inf",))
            lines.append(f"{self.name}_bucket{inf_labels} {total}")
            plain = _merge_labels(self.const_labels, self.label_names, key)
            lines.append(f"{self.name}_sum{plain} {total_sum}")
            lines.append(f"{self.name}_count{plain} {total}")
        return lines


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def _merge_labels(const: Dict[str, str], names: Tuple[str, ...],
                  values: Tuple[str, ...]) -> str:
    """Const labels (e.g. pool="v5p") prepended to the variable labels —
    how N pools share one registry without colliding series (the
    reference runs one process per pool instead)."""
    all_names = tuple(const.keys()) + names
    all_values = tuple(const.values()) + values
    return _fmt_labels(all_names, all_values)


class Registry:
    def __init__(self) -> None:
        self._metrics: List[object] = []
        # (name, label_names, const_labels) of every registration: N
        # pools legitimately repeat a family name with DIFFERENT
        # const-labels (pool="v5p" vs pool="v5e"); two instruments with
        # the SAME identity would expose duplicate sample lines that
        # Prometheus rejects and that double-count silently in-process
        # — the collision class a 16-pool app must fail loudly on.
        self._identities: set = set()
        # Multi-pool apps register instruments while scrape threads run
        # exposition(): same locked-access contract as the instruments
        # themselves (vodalint metrics-lock).
        self._lock = threading.Lock()

    def register(self, metric):
        identity = (metric.name,
                    tuple(getattr(metric, "label_names", ()) or ()),
                    tuple(sorted((getattr(metric, "const_labels", None)
                                  or {}).items())))
        with self._lock:
            if identity in self._identities:
                const = dict(identity[2])
                raise ValueError(
                    f"duplicate metric registration: {metric.name!r} with "
                    f"labels {identity[1]} const_labels {const} is already "
                    f"registered — two pools sharing one Registry must "
                    f"disambiguate with const-labels (e.g. pool=<name>)")
            self._identities.add(identity)
            self._metrics.append(metric)
        return metric

    def counter(self, name: str, help_: str, labels: Tuple[str, ...] = (),
                const_labels: Optional[Dict[str, str]] = None) -> Counter:
        return self.register(Counter(name, help_, labels,
                                     const_labels=const_labels))

    def gauge(self, name: str, help_: str,
              fn: Optional[Callable[[], float]] = None,
              labels: Tuple[str, ...] = (),
              const_labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self.register(Gauge(name, help_, fn, label_names=labels,
                                   const_labels=const_labels))

    def summary(self, name: str, help_: str, labels: Tuple[str, ...] = (),
                const_labels: Optional[Dict[str, str]] = None) -> Summary:
        return self.register(Summary(name, help_, labels,
                                     const_labels=const_labels))

    def histogram(self, name: str, help_: str, labels: Tuple[str, ...] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  const_labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets=buckets,
                                       const_labels=const_labels))

    def exposition(self) -> str:
        # Multi-pool registrations repeat metric names (same name, a
        # different pool const-label). The text format requires all of a
        # family's lines as ONE group with a single HELP/TYPE header, so
        # group collected lines by family name, in first-seen order.
        headers: Dict[str, List[str]] = {}
        samples: Dict[str, List[str]] = {}
        order: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            name = m.name
            if name not in samples:
                order.append(name)
                headers[name] = []
                samples[name] = []
            for line in m.collect():
                if line.startswith("# "):
                    if not headers[name] or line not in headers[name]:
                        if len(headers[name]) < 2:
                            headers[name].append(line)
                else:
                    samples[name].append(line)
        lines: List[str] = []
        for name in order:
            lines.extend(headers[name])
            lines.extend(samples[name])
        return "\n".join(lines) + "\n"


def nearest_rank_percentile(values, fraction: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation): the
    smallest sample at or above rank ceil(fraction * n). Rank arithmetic
    is exact-rational over the fraction's decimal literal, so p95 over
    20 samples is the 19th value — float ceil(0.95 * 20) lands on 20
    via 19.000000000000004 — and sub-percent quantiles (p99.9) keep
    their precision instead of rounding to p100. One implementation for
    every consumer (`voda top`, ingest_stats, scripts/perf_scale.py)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    frac = fractions.Fraction(str(fraction))
    rank = -((-frac.numerator * len(ordered)) // frac.denominator)
    rank = min(len(ordered), max(1, rank))
    return ordered[rank - 1]
