"""repro_torch.obs — the observability plane. This slice carries the
metric registry the engine's stats read; the rings, event log and
export follow in the observability slice."""
from .metrics import MetricSet, MetricSpec, ObsConfig

__all__ = ["MetricSet", "MetricSpec", "ObsConfig"]
