"""Observability (DESIGN.md §14): see the pipeline the search priced —
the port's copy of ``repro/obs``.

Three legs, all consuming the SAME artifacts the planner already
produces:

* ``trace`` — Chrome/Perfetto ``trace_events`` export of the event
  simulator's per-op spans (the *predicted* timeline) and of the
  pipeline runtime's fenced tick stamps (the *executed* timeline, via
  ``runtime.trace_pipeline``), one track per (dp replica, stage,
  chunk);
* ``metrics`` — counters/gauges/histograms with a JSONL sink
  (``run_dir/metrics.jsonl``), wired through ``launch/train.py`` and
  ``launch/serve.py``;
* ``align`` + ``straggler`` — predicted-vs-executed drift report and
  the per-replica / per-stage imbalance detector that compares measured
  shares against the plan's priced pacing allocation.

Everything in this package except ``runtime`` is importable without
torch (``python -m repro_torch.obs.validate`` is the schema gate for
emitted artifacts); ``runtime`` needs torch and ``torch.distributed``
and is imported lazily by the launcher.
"""
from .align import align_traces
from .metrics import (MET_SCHEMA_VERSION, Counter, Gauge, Histogram,
                      MetricsLogger, MetricsRegistry, percentile)
from .straggler import detect_stragglers, replica_stragglers, stage_stragglers
from .trace import (TRACE_SCHEMA_VERSION, build_trace, sim_spans,
                    validate_trace, write_trace)

__all__ = [
    "MET_SCHEMA_VERSION", "TRACE_SCHEMA_VERSION",
    "Counter", "Gauge", "Histogram", "MetricsLogger", "MetricsRegistry",
    "percentile", "align_traces", "detect_stragglers",
    "replica_stragglers", "stage_stragglers", "build_trace", "sim_spans",
    "validate_trace", "write_trace",
]
