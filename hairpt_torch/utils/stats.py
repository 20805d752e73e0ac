"""Render statistics registry (port of hairpt/utils/stats.py, the same
code).

Capability counterpart of the reference's StatsCounter/Statistics
(include/mitsuba/core/statistics.h:55-360, printed by
Statistics::printStats at the end of mitsuba.cpp:408). The reference
uses lock-free per-thread counter slots; here the integrators read
their counters back as host values after each wave and record them into
this (plain python) registry: the same report, no shared mutable device
state. Only integrators/path.render records (its rays, camera samples
and waves, and its render time and rate), as in the JAX package.

Kinds mirror statistics.h EStatsType: number / percentage (value/base)
/ average (value/base) / memory (bytes) / rate (value per second).
"""
from __future__ import annotations

import sys
import time
from collections import OrderedDict


class _Counter:
    __slots__ = ("kind", "value", "base")

    def __init__(self, kind):
        self.kind = kind
        self.value = 0.0
        self.base = 0.0


_registry: "OrderedDict[str, OrderedDict[str, _Counter]]" = OrderedDict()
_timers: dict = {}


def record(category: str, name: str, value, base=1.0, kind: str = "number"):
    """Accumulate `value` (and `base` for percentage/average kinds) into
    the counter `category/name`."""
    cat = _registry.setdefault(category, OrderedDict())
    c = cat.get(name)
    if c is None:
        c = cat[name] = _Counter(kind)
    c.value += float(value)
    c.base += float(base)


def start_timer(name: str):
    _timers[name] = time.time()


def stop_timer(category: str, name: str, work: float = 0.0,
               unit: str = ""):
    """Record elapsed seconds since start_timer(name); when `work` is
    given also record a rate counter (work/second, e.g. rays)."""
    dt = time.time() - _timers.pop(name, time.time())
    record(category, name + " time (s)", dt)
    if work:
        record(category, f"{name} rate ({unit}/s)", work, dt, kind="rate")
    return dt


def reset():
    _registry.clear()
    _timers.clear()


def _fmt(c: _Counter) -> str:
    if c.kind == "percentage":
        pct = 100.0 * c.value / max(c.base, 1e-12)
        return f"{c.value:.0f} / {c.base:.0f} ({pct:.2f} %)"
    if c.kind == "average":
        return f"{c.value / max(c.base, 1e-12):.3f} avg " \
               f"({c.value:.0f} / {c.base:.0f})"
    if c.kind == "memory":
        v = c.value
        for unit in ("B", "KiB", "MiB", "GiB"):
            if v < 1024 or unit == "GiB":
                return f"{v:.2f} {unit}"
            v /= 1024
    if c.kind == "rate":
        return f"{c.value / max(c.base, 1e-12):,.3f}"
    if c.value == int(c.value):
        return f"{c.value:,.0f}"
    return f"{c.value:,.3f}"


def format_stats() -> str:
    """Render the registry like Statistics::printStats (grouped by
    category, aligned)."""
    if not _registry:
        return "  (no statistics collected)"
    lines = ["------------------------------------------------------------",
             "  Render statistics:"]
    for cat, counters in _registry.items():
        lines.append(f"    * {cat}:")
        width = max(len(n) for n in counters)
        for name, c in counters.items():
            lines.append(f"        -  {name:<{width}} : {_fmt(c)}")
    lines.append("------------------------------------------------------------")
    return "\n".join(lines)


def print_stats(file=None):
    print(format_stats(), file=file or sys.stderr)
