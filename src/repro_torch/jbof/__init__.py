"""repro_torch.jbof — the JBOF substrate. So far it carries only the
SSD constants (`ssd`): the §4.6 unit costs that `core.costs` prices from
and the mapping-table geometry that sizes the FTL lookup; the simulator
comes in a later slice."""
from . import ssd

__all__ = ["ssd"]
