"""repro_torch.serving — XBOF-harvesting continuous-batching runtime."""
from . import engine, kv_pool, scenarios

__all__ = ["engine", "kv_pool", "scenarios"]
