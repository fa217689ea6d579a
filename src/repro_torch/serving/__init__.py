"""repro_torch.serving — XBOF-harvesting continuous-batching runtime."""
from . import engine, kv_pool

__all__ = ["engine", "kv_pool"]
