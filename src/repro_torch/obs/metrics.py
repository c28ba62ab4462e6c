"""Process-wide metrics registry: counters, gauges, histograms.

One :class:`Registry` (the module-level ``REGISTRY``) holds every metric the
process emits, addressed by dotted name.  Stats records that used to be
parallel bookkeeping — ``train.engine.EngineStats``, ``serve.engine
.ServeStats`` — are now *emitting views* over this registry via
:class:`StatsView`: their scalar fields live in registry metrics (each
instance under a unique ``<prefix>.<n>`` namespace), the legacy attribute
surface (``stats.compiles += 1``, ``stats.as_dict()``) is preserved
verbatim, and ``REGISTRY.snapshot()`` sees every engine in the process at
once.  The equivalence test in ``tests/test_obs.py`` pins each legacy field
against its registry entry so no bench/test consumer changes.

Counters carry monotonically-accumulated values (ints by convention),
gauges carry last-written values, histograms carry count/total/min/max plus
the last value.  Writes are GIL-atomic single-attribute stores; the registry
itself locks only metric creation.
"""

from __future__ import annotations

import itertools
import threading


class Counter:
    """Accumulated value: ``inc(n)`` adds, ``set(v)`` overwrites (the
    ``stats.field += 1`` surface reads then sets)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0

    def inc(self, n=1) -> None:
        self._v += n

    def set(self, v) -> None:
        self._v = v

    @property
    def value(self):
        return self._v


class Gauge:
    """Last-written value (floats or config-style ints)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0

    def set(self, v) -> None:
        self._v = v

    @property
    def value(self):
        return self._v


class Histogram:
    """Streaming summary: count / total / min / max / last."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "last")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self.last = None

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.last = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "total": self.total, "mean": self.mean,
                "min": self.vmin, "max": self.vmax, "last": self.last}


class Registry:
    """Name -> metric map; get-or-create, type-checked."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()
        self._seq = itertools.count()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str):
        return self._metrics.get(name)

    def unique_namespace(self, prefix: str) -> str:
        """A fresh per-instance namespace like ``train.engine.3`` — each
        StatsView claims one so engines in the same process never collide."""
        return f"{prefix}.{next(self._seq)}"

    def snapshot(self) -> dict:
        """Flat ``{name: value}`` view (histograms expand to summaries)."""
        with self._lock:
            items = list(self._metrics.items())
        return {
            name: m.summary() if isinstance(m, Histogram) else m.value
            for name, m in items
        }

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-wide registry every subsystem emits into
REGISTRY = Registry()


class StatsView:
    """Back a stats object's scalar fields by registry metrics.

    Subclasses declare ``_COUNTERS`` (accumulated ints) and ``_GAUGES``
    (last-written scalars); ``_init_metrics`` registers each under the
    instance namespace.  Attribute reads/writes on those names route to the
    registry — every other attribute (bools, lists) behaves normally, so the
    legacy dataclass surface (``+=``, ``.append``, ``as_dict``) is
    unchanged.
    """

    _COUNTERS: tuple[str, ...] = ()
    _GAUGES: tuple[str, ...] = ()

    def _init_metrics(self, prefix: str, registry: Registry | None = None) -> None:
        reg = registry if registry is not None else REGISTRY
        ns = reg.unique_namespace(prefix)
        fields = {}
        for f in self._COUNTERS:
            fields[f] = reg.counter(f"{ns}.{f}")
        for f in self._GAUGES:
            fields[f] = reg.gauge(f"{ns}.{f}")
        self.registry = reg
        self.namespace = ns
        # set last: __setattr__ routes through _metrics once it exists
        self._metrics = fields

    def __getattr__(self, name):
        m = object.__getattribute__(self, "__dict__").get("_metrics")
        if m is not None and name in m:
            return m[name].value
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    def __setattr__(self, name, value):
        m = self.__dict__.get("_metrics")
        if m is not None and name in m:
            m[name].set(value)
        else:
            object.__setattr__(self, name, value)

    def metric_dict(self) -> dict:
        """The registry-backed scalar fields, by field name."""
        return {f: self._metrics[f].value for f in (*self._COUNTERS, *self._GAUGES)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        body = ", ".join(f"{k}={v}" for k, v in self.metric_dict().items())
        return f"{type(self).__name__}({body})"
