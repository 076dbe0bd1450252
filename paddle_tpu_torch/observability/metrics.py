"""Metrics registry: counters, gauges, fixed-bucket histograms (the port's
own copy of the part of ``paddle_tpu/observability/metrics.py`` that the
training step's telemetry writes: the registry and its snapshot; the JSONL
and Prometheus dumps come with the serving control plane, see ROADMAP.md).

One process-wide registry that ``utils.metrics_bus`` and
``observability.dynamics`` publish into. Publishing is hot-path code: a
counter ``inc`` is one lock and one add; a histogram ``observe`` is a
bisect over a small tuple and two adds. Nothing here allocates per call or
touches the filesystem.
"""
import bisect
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "DEFAULT_BUCKETS", "metric_key"]


#: latency-oriented default bucket upper bounds, in seconds (an implicit
#: +inf bucket is always appended): 0.5ms .. 60s covers a dispatch through a
#: full checkpoint write.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic named counter: ``inc``, and ``reset`` for the registry's
    prefix reset."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0


class Gauge:
    """Last-value gauge that also keeps its high-water mark (``hwm``) since
    the last reset."""

    __slots__ = ("name", "_lock", "_value", "_hwm")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._hwm = 0.0

    def set(self, v):
        v = float(v)
        with self._lock:
            self._value = v
            if v > self._hwm:
                self._hwm = v

    @property
    def value(self):
        return self._value

    @property
    def hwm(self):
        return self._hwm

    def reset(self):
        with self._lock:
            self._value = 0.0
            self._hwm = 0.0


class Histogram:
    """Fixed-bucket histogram. ``bounds`` are the finite bucket upper
    limits; an implicit +inf bucket catches the tail."""

    __slots__ = ("name", "bounds", "_lock", "_counts", "_sum", "_count")

    def __init__(self, name, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # last = +inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def mean(self):
        return self._sum / self._count if self._count else 0.0

    def cumulative(self):
        """[(upper_bound, cumulative_count)], ending with (inf, count)."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(self.bounds + (float("inf"),), counts):
            cum += c
            out.append((b, cum))
        return out

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0


def _escape_label(v):
    """Label-value escaping: backslash, double quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def metric_key(name, labels=None):
    """Registry key for a (family, labels) pair: the family name alone when
    unlabeled, ``family{k="v",...}`` otherwise (sorted, escaped: two label
    dicts that render the same are the same series)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return name + "{" + inner + "}"


class MetricsRegistry:
    """Process-wide name -> metric map. Metric creation is idempotent
    (``counter("x")`` twice returns the same object); re-registering a name
    as a different type is a bug and raises. ``labels={...}`` registers one
    series of a metric family, keyed ``name{k="v"}``. ``help`` is accepted
    for the reference's signature; nothing here renders it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, name, cls, labels=None, **kw):
        key = metric_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(key, **kw)
        if not isinstance(m, cls):
            raise ValueError(f"metric {key!r} already registered as "
                             f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name, help="", labels=None):
        return self._get_or_create(name, Counter, labels)

    def gauge(self, name, help="", labels=None):
        return self._get_or_create(name, Gauge, labels)

    def histogram(self, name, buckets=DEFAULT_BUCKETS, help="", labels=None):
        return self._get_or_create(name, Histogram, labels, buckets=buckets)

    def get(self, name, labels=None):
        """Existing metric or None; never creates."""
        return self._metrics.get(metric_key(name, labels))

    def names(self, prefix=""):
        with self._lock:
            return sorted(n for n in self._metrics if n.startswith(prefix))

    def _items(self, prefix):
        with self._lock:
            return [(n, m) for n, m in self._metrics.items()
                    if n.startswith(prefix)]

    def snapshot(self, prefix=""):
        """{name: plain-python value}: counters as numbers, gauges as
        {value, hwm}, histograms as {count, sum, mean, buckets}. Zero-valued
        counters are omitted (the EventCounters contract: 'faults' is only
        present when something actually fired)."""
        out = {}
        for name, m in self._items(prefix):
            if isinstance(m, Counter):
                if m.value:
                    out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = {"value": m.value, "hwm": m.hwm}
            else:
                out[name] = {
                    "count": m.count, "sum": m.sum, "mean": m.mean,
                    "buckets": [[b, c] for b, c in m.cumulative()],
                }
        return out

    def reset(self, prefix=""):
        """Zero every metric under ``prefix`` (objects and handles stay
        valid; only values reset)."""
        for _, m in self._items(prefix):
            m.reset()


#: the process-wide singleton every layer publishes into
registry = MetricsRegistry()
