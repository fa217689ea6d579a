"""SSD constants (paper Table 1, §4.5, §4.6).

The port's own copy of the constants of `repro.jbof.ssd` that it reads:
the §4.6 unit costs that `core.costs` prices from, and the mapping-table
geometry that sizes the FTL lookup (a 4 TB SSD's table in 2 MB segments
of 4-byte entries, one per 4 KB slice). The rest of the SSD model moves
with the JBOF simulator slice.
"""
from __future__ import annotations

CXL_BPS_PER_SSD = 16e9            # CXL 3.0 / PCIe6 x2 per SSD (Table 1)
T_INTER_SSD_OP = 114.2e-9         # §4.6 measured: dequeue+unwrap a DMA/flash op
T_CXL_HOP = 400e-9                # sub-microsecond remote load/store (§5.3)
CMD_BYTES = 64.0                  # NVMe command + completion descriptors per op

SLICE_BYTES = 4 * 1024            # firmware translation unit (§2.1 step 4)
SSD_CAPACITY_TB = 4.0
SEGMENT_BYTES = 2 * 1024 * 1024   # §4.5 DRAM harvesting granularity
# one 2 MB segment of mapping table (4 B entries) covers 2 GB of flash:
FLASH_PER_SEGMENT = SEGMENT_BYTES // 4 * SLICE_BYTES          # 2 GiB
SEGMENTS_FULL = int(SSD_CAPACITY_TB * 1e12 / FLASH_PER_SEGMENT)  # ~1863
