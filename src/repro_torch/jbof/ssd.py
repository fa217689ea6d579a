"""SSD compute-end / data-end cost model (paper Table 1 + §3.1 calibration).

The port's own copy of `repro.jbof.ssd` (plain Python, the same values):
the §4.6 unit costs that `core.costs` prices from, the mapping-table
geometry that sizes the FTL lookup, and the rest of the SSD model the JBOF
simulator (`jbof.sim`) runs on.

All constants derive from Table 1 or are solved from the paper's own measured
operating points so that the simulator reproduces Fig. 4 *by construction*:

Calibration equations (3-core 1 GHz compute-end, 8-channel backbone):
  (1) 64 KB seq reads, QD64: proc util 95.4% while flash util 42.2%  (Fig 4b)
        X = 0.422 * F_READ_PAGES / 4 pages  = 92.3 K cmd/s
        X * (C_PARSE + 16 * C_READ_SLICE) = 0.954 * 3e9
        => C_PARSE + 16*C_READ_SLICE = 31 011 clocks
  (2) 4 KB seq writes: flash util 95.6% while proc util 57.6%        (Fig 4b)
        X * 0.25 page * SLC_AMP / F_PROG_PAGES = 0.956  => X = 1.166 M cmd/s
        X * (C_PARSE + C_WRITE_SLICE) = 0.576 * 3e9
        => C_PARSE + C_WRITE_SLICE = 1 482 clocks
  (3) OCSSD JBOF saturates at 4 SSDs of 64 KB reads                  (Fig 4a)
        4 * (F_READ_PAGES/4) * (C_PARSE + 16*C_READ_SLICE + C_HOST_FW)
          = HOST_CLOCKS_PER_S
        => C_HOST_FW ≈ 7.6 K host clocks per command

With C_PARSE = 600 we get C_READ_SLICE = 1 901, C_WRITE_SLICE = 882. These
three constants then *independently* land the paper's macro numbers
(Shrunk −29.2% micro, OC −27.8%, utilization +50.4%) — see benchmarks.
"""
from __future__ import annotations

from typing import NamedTuple

# ----------------------------------------------------------------- Table 1
PAGE_BYTES = 16 * 1024            # flash page
SLICE_BYTES = 4 * 1024            # firmware translation unit (§2.1 step 4)
N_CHANNELS = 8
SSD_CAPACITY_TB = 4.0
PEAK_READ_BPS = 14e9              # Table 1
PEAK_WRITE_BPS = 10e9

T_READ_LSB = 30e-6                # flash sense latencies
T_READ_CSB = 45e-6
T_READ_MSB = 60e-6
T_READ_AVG = 45e-6
T_PROG_AVG = 293e-6               # (200+280+400)/3
T_ERASE = 3e-3

# derived page-slot capacities (pages/s at 100% backbone utilization)
F_READ_PAGES = PEAK_READ_BPS / PAGE_BYTES    # 854 492 pages/s
F_PROG_PAGES = PEAK_WRITE_BPS / PAGE_BYTES   # 610 351 pages/s
SLC_AMP_SMALL_WRITE = 2.0         # sub-page writes: SLC-cache staging + fold
CHANNEL_BUS_BPS = 2.4e9 * N_CHANNELS  # 2400 MT/s x 8 bit x 8 channels

# ------------------------------------------------- compute-end (solved above)
CLOCK_HZ = 1.0e9                  # embedded ARM core clock
CONV_CORES = 6                    # Conv compute-end
SHRUNK_CORES = 3                  # Shrunk / XBOF compute-end (half resources)
C_PARSE = 600.0                   # clocks: NVMe fetch + parse per command
C_READ_SLICE = 1901.0             # clocks: translate + ECC sched + DMA, per 4 KB read slice
C_WRITE_SLICE = 882.0             # clocks: allocate + buffer + program sched, per 4 KB write slice
C_MISS_EXTRA = 500.0              # clocks: mapping-page fetch bookkeeping on a miss

DRAM_GB_PER_TB_FULL = 1.0         # Conv provisioning (Table 1)
DRAM_LOOKUP_S = 100e-9            # onboard DRAM mapping lookup
MAPPING_PAGE_READ_S = T_READ_LSB  # mapping pages live in fast (LSB/SLC) flash
SEGMENT_BYTES = 2 * 1024 * 1024   # §4.5 DRAM harvesting granularity
# one 2 MB segment of mapping table (4 B entries) covers 2 GB of flash:
FLASH_PER_SEGMENT = SEGMENT_BYTES // 4 * SLICE_BYTES          # 2 GiB
SEGMENTS_FULL = int(SSD_CAPACITY_TB * 1e12 / FLASH_PER_SEGMENT)  # ~1863

# ------------------------------------------------------------------ host/DPU
HOST_CORES = 16                   # BlueField-3 class DPU
HOST_CLOCK_HZ = 2.1e9
HOST_CLOCKS_PER_S = HOST_CORES * HOST_CLOCK_HZ
C_HOST_DRIVER = 1500.0            # host clocks: NVMe driver per command (all platforms)
C_HOST_FW = 3000.0                # extra host clocks per command for OC firmware-on-host
OC_HOST_INEFF = 1.8               # host runs firmware ~1.8x slower per clock
                                  # (kernel I/O stack, cache pollution vs. bare-metal
                                  # embedded firmware; calibrated to Fig 4a/9)
C_HOST_VH = 9000.0                # extra host clocks per command for VH central mgmt
C_HOST_LB = 42.0                  # §5.3: "20 ns more host CPU time per command" @2.1GHz

# --------------------------------------------------------------- CXL fabric
CXL_BPS_PER_SSD = 16e9            # CXL 3.0 / PCIe6 x2 per SSD (Table 1)
T_INTER_SSD_OP = 114.2e-9         # §4.6 measured: dequeue+unwrap a DMA/flash op
T_LOG_COMMIT = 321.9e-9           # §4.6 measured: redo-log commit
SYNC_PROC_OVERHEAD = 0.031        # §5.3: +3.1% processor time on redirected work
T_CXL_HOP = 400e-9                # sub-microsecond remote load/store (§5.3)
CMD_BYTES = 64.0                  # NVMe command + completion descriptors per op

# FLAT-model fallback (`Platform.flat_sync=True`): redirected backbone work
# and pooled link bytes pay a constant dispatch tax analogous to
# SYNC_PROC_OVERHEAD. The default per-op model (`repro.core.costs`) prices
# the same §4.6 components — dequeue/unwrap, hops, payload bytes — per
# operation instead, so the tax scales with I/O size; these constants are
# retained so pre-refactor fig10/fig19 baselines stay reproducible.
SYNC_FLASH_OVERHEAD = 0.05        # extra channel time on redirected flash work
SYNC_LINK_OVERHEAD = 0.02         # multipath tax on borrowed link bytes
# flat-model byte rate of redirected backbone work on the fabric: a donated
# channel-second moves roughly a program-rate worth of data across the link
# (per-op model: `costs.assist_link_bps` derives this from the I/O size)
FLASH_ASSIST_BPS = PEAK_WRITE_BPS

# ------------------------------------------------------------------- energy
E_CXL_PJ_PER_BIT = 6.0
SSD_PROC_W_FULL = 6.45            # 6-core compute-end at full tilt
E_DRAM_PJ_PER_BIT = 22.0
FLASH_V = 3.3
I_READ = I_PROG = I_ERASE = 25e-3
I_BUSIDLE = 5e-3
I_STDBY = 10e-6

# ------------------------------------------------------------- latency path
T_HOST_STACK = 5e-6               # host I/O stack per command (Fig 14 "Host")
T_HOST_SSD_CMD = 1e-6             # doorbell + command fetch


class SSDConfig(NamedTuple):
    """Per-SSD resource provisioning for one platform."""

    cores: float = CONV_CORES
    dram_gb_per_tb: float = DRAM_GB_PER_TB_FULL
    cxl: bool = False             # CXL-enabled (XBOF) vs PCIe-only

    @property
    def proc_clocks_per_s(self) -> float:
        return self.cores * CLOCK_HZ

    @property
    def dram_segments(self) -> int:
        """Mapping-table cache capacity in 2 MB segments."""
        frac = self.dram_gb_per_tb / DRAM_GB_PER_TB_FULL
        return max(int(SEGMENTS_FULL * frac), 1)


def proc_clocks_per_cmd(read: bool, io_bytes: float) -> float:
    """Compute-end clocks to serve one command of ``io_bytes``."""
    slices = max(io_bytes / SLICE_BYTES, 1.0)
    per_slice = C_READ_SLICE if read else C_WRITE_SLICE
    return C_PARSE + slices * per_slice


def flash_pages_per_cmd(read: bool, io_bytes: float) -> float:
    """Equivalent flash page-slots consumed by one command.

    Reads: ceil(bytes/page). Writes smaller than a page pay SLC-cache
    staging + fold amplification (they are buffered, but the backbone
    eventually programs ~2x the bytes; paper §4.6 'SLC cache')."""
    pages = io_bytes / PAGE_BYTES
    if read:
        return max(pages, 1.0)
    amp = SLC_AMP_SMALL_WRITE if io_bytes < PAGE_BYTES else 1.0
    return max(pages * amp, 0.25)


def service_latency_s(
    read: bool,
    io_bytes: float,
    cores: float,
    miss_ratio: float,
    remote_fraction: float = 0.0,
) -> float:
    """Unloaded per-command service latency decomposition (Fig 14a terms).

    Returned value = Host + Host-SSD + Processor + DRAM + Flash + Inter-SSD.
    Queueing delay is added by the simulator from backlog (Little's law).
    """
    slices = max(io_bytes / SLICE_BYTES, 1.0)
    proc = proc_clocks_per_cmd(read, io_bytes) / CLOCK_HZ
    proc = proc * (1.0 + SYNC_PROC_OVERHEAD * remote_fraction)
    dram = DRAM_LOOKUP_S * slices
    flash_t = T_READ_AVG if read else T_PROG_AVG / 4  # program hidden by buffer
    xfer = io_bytes / (CHANNEL_BUS_BPS / N_CHANNELS)
    flash = flash_t + xfer + miss_ratio * slices * MAPPING_PAGE_READ_S
    inter = remote_fraction * (T_INTER_SSD_OP * 2 + T_CXL_HOP * slices)
    link = io_bytes / CXL_BPS_PER_SSD + T_HOST_SSD_CMD
    return T_HOST_STACK + link + proc + dram + flash + inter
