"""A small Prometheus client: ``Counter``, ``Gauge`` and ``Histogram``
with labels, a ``CollectorRegistry``, and ``generate_latest``, which
writes the text format 0.0.4 (what ``pkg/metrics.py`` builds on).

The port does not import ``prometheus_client``; this module keeps the
parts of its surface the JAX package's metrics use, with its semantics:

- a Counter named ``x_total`` is the family ``x`` and its sample
  ``x_total``; a Histogram's buckets get ``+Inf`` appended and are
  exposed cumulative, then ``_count``, then ``_sum``;
- label values are strings (``str()`` of what is passed), escaped as
  Prometheus escapes them (backslash, newline, double quote), and a
  sample's labels are written sorted by name;
- numbers are written as Go writes floats (``1.0``, ``+Inf``, ``1e+06``);
- a family without labels has its one sample from the start; a labelled
  family has none until ``labels()`` makes a child;
- registering a name twice in one registry raises ``ValueError``.

What it leaves out: the ``_created`` samples ``prometheus_client`` adds
to counters and histograms (timestamps of a child's creation, written as
gauges of their own), exemplars (0.0.4 has none: an observation's
exemplar is checked as ``prometheus_client`` checks it, and dropped),
summaries, info and enum metrics, and the multiprocess mode.
"""

from __future__ import annotations

import math
import re
import threading

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
INF = float("inf")


def float_to_go_string(value) -> str:
    """A float as Prometheus' Go server writes it (``prometheus_client``'s
    ``floatToGoString``)."""
    d = float(value)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python.
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace(
        '"', r"\"")


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


class CollectorRegistry:
    """The metrics one ``/metrics`` endpoint exposes, in the order they
    were registered."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: list = []
        self._names: set[str] = set()

    def register(self, metric) -> None:
        names = set(metric.sample_names())
        with self._lock:
            dup = self._names & names
            if dup:
                raise ValueError(
                    f"Duplicated timeseries in CollectorRegistry: {dup}")
            self._names |= names
            self._metrics.append(metric)

    def collect(self) -> list:
        with self._lock:
            return list(self._metrics)


class _Child:
    """One labelled series' value(s)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0


class _MetricBase:
    """Shared by the three kinds: the name, help, label names, the
    children by label values, and registration."""

    TYPE = ""

    def __init__(self, name: str, documentation: str,
                 labelnames=(), registry: CollectorRegistry | None = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"Invalid metric name: {name}")
        self._name = self._family_name(name)
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        for label in self._labelnames:
            if not _LABEL_RE.match(label) or label.startswith("__"):
                raise ValueError(f"Invalid label metric name: {label}")
        self._reserved_labels(self._labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        # A family without labels is its own (only) child.
        self._self_child = None if self._labelnames else self._new_child()
        if registry is not None:
            registry.register(self)

    @staticmethod
    def _family_name(name: str) -> str:
        return name

    def _reserved_labels(self, labelnames) -> None:
        pass

    def _new_child(self):
        return _Child()

    def sample_names(self) -> list[str]:
        return [self._name]

    # -- children ---------------------------------------------------------

    def labels(self, *labelvalues, **labelkwargs):
        """The child of one label set (made at first use)."""
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing "
                             f"{self._name}")
        if labelvalues and labelkwargs:
            raise ValueError("Can't pass both *args and **kwargs")
        if labelkwargs:
            if sorted(labelkwargs) != sorted(self._labelnames):
                raise ValueError("Incorrect label names")
            labelvalues = tuple(labelkwargs[n] for n in self._labelnames)
        if len(labelvalues) != len(self._labelnames):
            raise ValueError("Incorrect label count")
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def remove(self, *labelvalues) -> None:
        """Drop one label set's series (no error when it has none)."""
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing "
                             f"{self._name}")
        if len(labelvalues) != len(self._labelnames):
            raise ValueError("Incorrect label count")
        with self._lock:
            self._children.pop(tuple(str(v) for v in labelvalues), None)

    def _own(self):
        if self._self_child is None:
            raise ValueError(f"{self._name} has labels: call labels() "
                             "first")
        return self._self_child

    def _series(self) -> list[tuple[dict, object]]:
        if self._self_child is not None:
            return [({}, self._self_child)]
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self._labelnames, key)), child)
                for key, child in items]

    # -- exposition -------------------------------------------------------

    def samples(self) -> list[tuple[str, dict, float]]:
        """(sample name, labels, value) of every series, in the order
        the text format lists them."""
        out = []
        for labels, child in self._series():
            out.extend(self._child_samples(labels, child))
        return out

    def _child_samples(self, labels: dict, child) -> list:
        with child._lock:
            return [(self._name, labels, child.value)]

    def exposition_name(self) -> str:
        return self._name


class Counter(_MetricBase):
    """A value that only goes up."""

    TYPE = "counter"

    @staticmethod
    def _family_name(name: str) -> str:
        return name[:-len("_total")] if name.endswith("_total") else name

    def sample_names(self) -> list[str]:
        return [self._name, f"{self._name}_total", f"{self._name}_created"]

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1) -> None:
        self._own().inc(amount)

    def _child_samples(self, labels: dict, child) -> list:
        with child._lock:
            return [(f"{self._name}_total", labels, child.value)]

    def exposition_name(self) -> str:
        return f"{self._name}_total"


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("Counters can only be incremented by "
                             "non-negative amounts.")
        with self._lock:
            self.value += amount


class Gauge(_MetricBase):
    """A value that goes up and down."""

    TYPE = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def inc(self, amount: float = 1) -> None:
        self._own().inc(amount)

    def dec(self, amount: float = 1) -> None:
        self._own().dec(amount)

    def set(self, value: float) -> None:
        self._own().set(value)


class _GaugeChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


DEFAULT_BUCKETS = (.005, .01, .025, .05, .075, .1, .25, .5, .75, 1.0, 2.5,
                   5.0, 7.5, 10.0, INF)


class Histogram(_MetricBase):
    """Observations counted into cumulative ``le`` buckets, with their
    count and sum."""

    TYPE = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry: CollectorRegistry | None = None,
                 buckets=DEFAULT_BUCKETS):
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if bounds and bounds[-1] != INF:
            bounds.append(INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        self._bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _reserved_labels(self, labelnames) -> None:
        if "le" in labelnames:
            raise ValueError("Reserved label metric name: le")

    def sample_names(self) -> list[str]:
        return [self._name] + [f"{self._name}{s}" for s in (
            "_bucket", "_count", "_sum", "_created")]

    def _new_child(self):
        return _HistogramChild(self._bounds)

    def observe(self, amount: float, exemplar: dict | None = None) -> None:
        self._own().observe(amount, exemplar)

    def _child_samples(self, labels: dict, child) -> list:
        with child._lock:
            counts = list(child.counts)
            total = child.sum
        out, acc = [], 0.0
        for bound, n in zip(self._bounds, counts):
            acc += n
            out.append((f"{self._name}_bucket",
                        {**labels, "le": float_to_go_string(bound)}, acc))
        out.append((f"{self._name}_count", labels, acc))
        if self._bounds[0] >= 0:
            out.append((f"{self._name}_sum", labels, total))
        return out


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "counts", "sum")

    def __init__(self, bounds: tuple):
        self._lock = threading.Lock()
        self._bounds = bounds
        self.counts = [0.0] * len(bounds)
        self.sum = 0.0

    def observe(self, amount: float, exemplar: dict | None = None) -> None:
        if exemplar is not None:
            # prometheus_client's rule: at most 128 characters of names
            # and values together.
            if sum(len(k) + len(str(v)) for k, v in exemplar.items()) > 128:
                raise ValueError("Exemplar labels have 129 or more "
                                 "characters")
        amount = float(amount)
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self._bounds):
                if amount <= bound:
                    self.counts[i] += 1
                    break


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The registry in the Prometheus text format 0.0.4."""
    out = []
    for metric in registry.collect():
        name = metric.exposition_name()
        out.append(f"# HELP {name} {_escape_help(metric._documentation)}\n")
        out.append(f"# TYPE {name} {metric.TYPE}\n")
        for sample, labels, value in metric.samples():
            if labels:
                text = ",".join(f'{k}="{_escape_label(v)}"'
                                for k, v in sorted(labels.items()))
                out.append(f"{sample}{{{text}}} "
                           f"{float_to_go_string(value)}\n")
            else:
                out.append(f"{sample} {float_to_go_string(value)}\n")
    return "".join(out).encode("utf-8")
