"""SSD unit costs (paper Table 1 + §4.6) that `core.costs` prices from.

The port's own copy of the four constants of `repro.jbof.ssd` that the
per-op cost table reads; the rest of the SSD model moves with the JBOF
simulator slice.
"""
from __future__ import annotations

CXL_BPS_PER_SSD = 16e9            # CXL 3.0 / PCIe6 x2 per SSD (Table 1)
T_INTER_SSD_OP = 114.2e-9         # §4.6 measured: dequeue+unwrap a DMA/flash op
T_CXL_HOP = 400e-9                # sub-microsecond remote load/store (§5.3)
CMD_BYTES = 64.0                  # NVMe command + completion descriptors per op
