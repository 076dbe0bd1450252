"""Metrics registry: counters, gauges, fixed-bucket histograms (the port's
own copy of ``paddle_tpu/observability/metrics.py``).

One process-wide registry that every layer of the port publishes into: the
training step's telemetry (``utils.metrics_bus``, ``observability.
dynamics``), the engine's ``serve.*`` series and the serving control
plane's ``serving.*``, ``brownout.*``, ``breaker.*``, ``kv.*`` and
``supervisor.*`` series, labeled by family. It dumps three ways: a
structured series export that a fleet snapshot carries and another
registry reloads (``export`` / ``load_series``), JSONL (``dump_jsonl``) and
the Prometheus text exposition that ``/varz`` serves (``to_prometheus``).
Publishing is hot-path code: a counter ``inc`` is one lock and one add; a
histogram ``observe`` is a bisect over a small tuple and two adds. Nothing
on that path allocates or touches the filesystem: rendering happens only in
the dumps.
"""
import bisect
import json
import os
import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "DEFAULT_BUCKETS", "metric_key"]

#: latency-oriented default bucket upper bounds, in seconds (an implicit
#: +inf bucket is always appended): 0.5ms .. 60s covers a dispatch through a
#: full checkpoint write.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic named counter. ``inc`` only; ``reset`` exists for tests and
    for the EventCounters compat shim's prefix reset."""

    __slots__ = ("name", "help", "family", "labels", "_lock", "_value")

    def __init__(self, name, help="", family=None, labels=None):
        self.name = name
        self.help = help
        self.family = family or name
        self.labels = labels
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
    """Last-value gauge. Also tracks the high-water mark (``hwm``) since the
    last reset — queue depth / slot occupancy are only interesting at their
    peaks, and a scrape-time gauge alone misses transients."""

    __slots__ = ("name", "help", "family", "labels", "_lock", "_value", "_hwm")

    def __init__(self, name, help="", family=None, labels=None):
        self.name = name
        self.help = help
        self.family = family or name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0
        self._hwm = 0.0

    def set(self, v):
        v = float(v)
        with self._lock:
            self._value = v
            if v > self._hwm:
                self._hwm = v

    def inc(self, n=1):
        with self._lock:
            self._value += n
            if self._value > self._hwm:
                self._hwm = self._value

    def dec(self, n=1):
        self.inc(-n)

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
    """Fixed-bucket histogram (Prometheus-style cumulative export).

    ``bounds`` are the finite bucket upper limits; an implicit +inf bucket
    catches the tail. Per-``observe`` cost is a bisect over the bounds tuple
    plus two adds under the lock — no per-call allocation.
    """

    __slots__ = ("name", "help", "family", "labels", "bounds", "_lock",
                 "_counts", "_sum", "_count")

    def __init__(self, name, buckets=DEFAULT_BUCKETS, help="", family=None,
                 labels=None):
        self.name = name
        self.help = help
        self.family = family or name
        self.labels = labels
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

    def bucket_counts(self):
        """Raw (non-cumulative) per-bucket counts, +inf bucket last."""
        with self._lock:
            return list(self._counts)

    def cumulative(self):
        """[(upper_bound, cumulative_count)], ending with (inf, count)."""
        out, cum = [], 0
        counts = self.bucket_counts()
        for b, c in zip(self.bounds, counts[:-1]):
            cum += c
            out.append((b, cum))
        out.append((float("inf"), cum + counts[-1]))
        return out

    def quantile(self, q):
        """Bucket-resolution quantile estimate: the smallest upper bound
        whose cumulative count reaches q*count (inf if it lands in the
        overflow bucket). Good enough for p50/p99 dashboards; exact values
        need a trace, not a histogram."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if not self._count:
            return 0.0
        target = q * self._count
        for bound, cum in self.cumulative():
            if cum >= target:
                return bound
        return float("inf")

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0


_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    n = _PROM_SANITIZE.sub("_", name)
    return "_" + n if n[:1].isdigit() else n


def _escape_label(v):
    """Prometheus label-value escaping: backslash, double quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(s):
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def _label_suffix(labels, extra=None):
    """``{k="v",...}`` rendered suffix (labels sorted, values escaped);
    empty string when there is nothing to render."""
    pairs = []
    if labels:
        pairs.extend(sorted(labels.items()))
    if extra:
        pairs.extend(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def metric_key(name, labels=None):
    """Registry key for a (family, labels) pair — the family name alone when
    unlabeled, ``family{k="v",...}`` otherwise (sorted, escaped — two label
    dicts that render the same ARE the same series)."""
    if not labels:
        return name
    return name + _label_suffix(labels)


class MetricsRegistry:
    """Process-wide name -> metric map. Metric creation is idempotent
    (``counter("x")`` twice returns the same object); re-registering a name
    as a different type is a bug and raises. ``labels={...}`` registers one
    series of a metric FAMILY (keyed ``name{k="v"}``): the Prometheus
    rendering groups series under one ``# TYPE``/``# HELP`` header, which is
    what real scrapers require (a per-label-value metric NAME breaks every
    aggregation over the family)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._family_types = {}

    def _get_or_create(self, name, cls, labels=None, **kw):
        key = metric_key(name, labels)
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {key!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                fcls = self._family_types.setdefault(name, cls)
                if fcls is not cls:
                    # a family mixing types renders an unparseable exposition
                    raise ValueError(
                        f"metric family {name!r} already registered as "
                        f"{fcls.__name__}, not {cls.__name__}")
                m = self._metrics[key] = cls(
                    key, family=name,
                    labels=dict(labels) if labels else None, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {key!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name, help="", labels=None):
        return self._get_or_create(name, Counter, help=help, labels=labels)

    def gauge(self, name, help="", labels=None):
        return self._get_or_create(name, Gauge, help=help, labels=labels)

    def histogram(self, name, buckets=DEFAULT_BUCKETS, help="", labels=None):
        return self._get_or_create(name, Histogram, buckets=buckets,
                                   help=help, labels=labels)

    def get(self, name, labels=None):
        """Existing metric or None — never creates."""
        return self._metrics.get(metric_key(name, labels))

    def remove(self, name, labels=None):
        """Delete one series (the fleet aggregator retiring a departed
        rank's labeled gauge — a rank that left the world must vanish
        from the exposition, not report its last score forever). The
        family's type registration is kept. Returns True if removed."""
        with self._lock:
            return self._metrics.pop(metric_key(name, labels),
                                     None) is not None

    def names(self, prefix=""):
        with self._lock:
            return sorted(n for n in self._metrics if n.startswith(prefix))

    # ---- snapshots ---------------------------------------------------------
    def snapshot(self, prefix=""):
        """{name: plain-python value} — counters/gauges as numbers,
        histograms as {count, sum, mean, buckets}. Zero-valued counters are
        omitted (the EventCounters contract: 'faults' is only present when
        something actually fired)."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if not name.startswith(prefix):
                continue
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

    def export(self, prefixes=None):
        """Merge-ready structured series dump (the fleet snapshot
        payload): unlike :meth:`snapshot`, every record carries the family,
        type, labels, and — for histograms — the bucket BOUNDS alongside the
        raw counts, so a cross-rank aggregator can rebuild exact mergeable
        metrics instead of lossy summaries. Zero-valued counters and empty
        histograms are omitted (the snapshot bound matters more than
        registering silence)."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for name, m in items:
            if prefixes and not m.family.startswith(tuple(prefixes)):
                continue
            rec = {"name": name, "family": m.family, "labels": m.labels,
                   "help": m.help}
            if isinstance(m, Counter):
                if not m.value:
                    continue
                rec["type"] = "counter"
                rec["value"] = m.value
            elif isinstance(m, Gauge):
                rec["type"] = "gauge"
                rec["value"] = m.value
                rec["hwm"] = m.hwm
            else:
                if not m.count:
                    continue
                rec["type"] = "histogram"
                rec["bounds"] = list(m.bounds)
                rec["counts"] = m.bucket_counts()
                rec["sum"] = m.sum
                rec["count"] = m.count
            out.append(rec)
        return out

    def load_series(self, rec, extra_labels=None):
        """Recreate one :meth:`export` record in THIS registry, optionally
        widening its label set (the aggregator adds ``rank=``/``replica=``
        so merged families stay one ``# TYPE`` with per-source series).
        Returns the metric, or None when the record's family is already
        registered here as a different type (conflicting sources must not
        kill a merge)."""
        labels = dict(rec.get("labels") or {})
        if extra_labels:
            labels.update(extra_labels)
        kind = rec.get("type")
        help_ = rec.get("help") or ""
        family = rec["family"]
        try:
            if kind == "counter":
                m = self.counter(family, help=help_, labels=labels)
                m.inc(rec.get("value", 0))
            elif kind == "gauge":
                m = self.gauge(family, help=help_, labels=labels)
                # set() tracks the high-water mark: replay hwm first so the
                # merged gauge carries the source's peak, then the live value
                m.set(rec.get("hwm", rec.get("value", 0.0)))
                m.set(rec.get("value", 0.0))
            elif kind == "histogram":
                m = self.histogram(family, buckets=rec["bounds"],
                                   help=help_, labels=labels)
                counts = list(rec.get("counts") or ())
                with m._lock:
                    for i, c in enumerate(counts[:len(m._counts)]):
                        m._counts[i] += int(c)
                    m._sum += float(rec.get("sum", 0.0))
                    m._count += int(rec.get("count", 0))
            else:
                return None
        except ValueError:
            return None
        return m

    def dump_jsonl(self, path, extra=None):
        """Append one JSON record per metric (plus the optional ``extra``
        dict on each line — rank/step stamps). Atomic enough for a telemetry
        sidecar: one write + flush per call."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        base = dict(extra) if extra else {}
        lines = []
        for name, val in self.snapshot().items():
            rec = dict(base)
            rec["name"] = name
            rec["value"] = val
            lines.append(json.dumps(rec))
        with open(path, "a") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
            f.flush()

    def to_prometheus(self):
        """Prometheus text exposition format (the text a real scraper must
        parse — asserted against a strict parser in tests): dots in metric
        names become underscores, every family gets ``# HELP``/``# TYPE``
        headers and contiguous samples, label values are escaped, and
        histograms render the standard cumulative ``_bucket{le=...}`` series
        (``+Inf`` included) plus ``_sum``/``_count``."""
        lines = []
        with self._lock:
            items = sorted(self._metrics.items())
        families = {}
        for _, m in items:
            families.setdefault(m.family, []).append(m)

        def _header(pname, ms, kind):
            help_text = next((m.help for m in ms if m.help), "")
            if help_text:
                lines.append(f"# HELP {pname} {_escape_help(help_text)}")
            lines.append(f"# TYPE {pname} {kind}")

        for family in sorted(families):
            ms = families[family]
            pname = _prom_name(family)
            if isinstance(ms[0], Counter):
                _header(pname, ms, "counter")
                for m in ms:
                    lines.append(f"{pname}{_label_suffix(m.labels)} {m.value}")
            elif isinstance(ms[0], Gauge):
                _header(pname, ms, "gauge")
                for m in ms:
                    lines.append(f"{pname}{_label_suffix(m.labels)} {m.value}")
                # the high-water mark is its own gauge family (a second
                # sample under the same name would be a duplicate series)
                lines.append(f"# TYPE {pname}_hwm gauge")
                for m in ms:
                    lines.append(
                        f"{pname}_hwm{_label_suffix(m.labels)} {m.hwm}")
            else:
                _header(pname, ms, "histogram")
                for m in ms:
                    for bound, cum in m.cumulative():
                        le = "+Inf" if bound == float("inf") else repr(bound)
                        suffix = _label_suffix(m.labels, extra=[("le", le)])
                        lines.append(f"{pname}_bucket{suffix} {cum}")
                    lines.append(
                        f"{pname}_sum{_label_suffix(m.labels)} {m.sum}")
                    lines.append(
                        f"{pname}_count{_label_suffix(m.labels)} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self, prefix=""):
        """Zero every metric under ``prefix`` (objects and handles stay
        valid — only values reset)."""
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if name.startswith(prefix):
                m.reset()


#: the process-wide singleton every layer publishes into
registry = MetricsRegistry()
