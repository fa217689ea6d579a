"""repro_torch.jbof — the JBOF substrate. This slice carries only the
§4.6 unit costs (`ssd`) that `core.costs` prices from; the simulator
comes in a later slice."""
from . import ssd

__all__ = ["ssd"]
