"""Structured metrics: gauges and histograms with a JSONL sink (the part
of ``repro/obs/metrics.py`` that serving uses, copied so the port imports
nothing of ``repro``; the rows have the same schema).

The sink writes one JSON object per line to ``run_dir/metrics.jsonl``:
a leading ``{"kind": "meta", "schema_version": ...}`` row describing the
run, then ``{"kind": "metrics", ...}`` rows carrying the registry
snapshot plus any direct values and ``{"kind": "histogram", "name":
...}`` summary rows.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

MET_SCHEMA_VERSION = 1


def percentile(sorted_samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the ⌈q·n⌉-th smallest of ``sorted_samples``
    (index ``ceil(q·n) − 1``)."""
    n = len(sorted_samples)
    if n == 0:
        raise ValueError("percentile of an empty sample list")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1]: {q}")
    return sorted_samples[max(1, math.ceil(q * n)) - 1]


class Gauge:
    """Last-set value (``None`` until first set; skipped in snapshots)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = float(v)


class Histogram:
    """Sample accumulator summarized as count/mean/min/max/p50/p95."""

    __slots__ = ("samples",)

    def __init__(self):
        self.samples: List[float] = []

    def observe(self, v) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0}
        srt = sorted(self.samples)
        return {
            "count": len(srt),
            "mean": sum(srt) / len(srt),
            "min": srt[0],
            "max": srt[-1],
            "p50": percentile(srt, 0.50),
            "p95": percentile(srt, 0.95),
        }


class MetricsRegistry:
    """Create-on-first-use registry; ``snapshot()`` flattens everything
    into one JSON-ready dict (histograms as ``name.p50`` etc.)."""

    def __init__(self):
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, g in self._gauges.items():
            if g.value is not None:
                out[name] = g.value
        for name, h in self._histograms.items():
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        return out


def _jsonable(v):
    """Coerce numpy/torch scalars (anything float()-able that json would
    reject) without importing their libraries."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class MetricsLogger:
    """The JSONL sink: owns a registry and a ``metrics.jsonl`` under
    ``run_dir``, writing the versioned meta row up front."""

    def __init__(self, run_dir: str, *, filename: str = "metrics.jsonl",
                 meta: Optional[dict] = None):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, filename)
        self.registry = MetricsRegistry()
        self._f = open(self.path, "w", encoding="utf-8")
        self._row({"kind": "meta", "schema_version": MET_SCHEMA_VERSION,
                   **(meta or {})})

    def _row(self, row: dict) -> None:
        row.setdefault("ts", time.time())
        self._f.write(json.dumps(_jsonable(row)) + "\n")
        self._f.flush()

    def log(self, step: Optional[int] = None, **values) -> None:
        """One metrics row: the registry snapshot plus direct values
        (direct values win on name collision)."""
        row: dict = {"kind": "metrics"}
        if step is not None:
            row["step"] = int(step)
        row.update(self.registry.snapshot())
        row.update(values)
        self._row(row)

    def log_histogram(self, name: str,
                      hist: Optional[Histogram] = None) -> None:
        """One summary row for a histogram (the registry's by default)."""
        h = hist if hist is not None else self.registry.histogram(name)
        self._row({"kind": "histogram", "name": name, **h.summary()})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
