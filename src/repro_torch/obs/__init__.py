"""repro_torch.obs — the observability plane (port of `repro.obs`).

In-step metric rings (`metrics`), grant-lifecycle event logs (`spans`),
and host-side JSON-lines / perfetto export (`export`), used by the
serving engine.
"""
from .export import annotate, scope, to_perfetto, write_report
from .metrics import MetricSet, MetricSpec, MetricsState, ObsConfig, merge_lead
from .spans import (EventLog, append, decode, grant_event_rows, make_log,
                    table_event_rows)

__all__ = [
    "MetricSet", "MetricSpec", "MetricsState", "ObsConfig", "merge_lead",
    "EventLog", "append", "decode", "grant_event_rows", "make_log",
    "table_event_rows",
    "annotate", "scope", "to_perfetto", "write_report",
]
