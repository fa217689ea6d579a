"""repro_torch.data — the deterministic synthetic data pipeline."""
from . import pipeline

__all__ = ["pipeline"]
