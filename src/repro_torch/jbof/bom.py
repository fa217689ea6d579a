"""BOM cost model (paper §5.2, Fig. 12).

The port's own copy of `repro.jbof.bom` (plain Python, the same values).

Market prices (paper's sources [22, 58, 60, 66, 87, 97, 98]):
  NAND flash            $4.95 / 128 GB
  DDR4 DRAM             $7.20 / GB
  enterprise controller $48 (full, 6-core class)
  other (PCB, packaging) $6
Halved compute resources cost half; CXL-enabled controller and DRAM carry a
10% premium (paper's reference [95]).
"""
from __future__ import annotations

NAND_PER_128GB = 4.95
DRAM_PER_GB = 7.20
CONTROLLER_FULL = 48.0
OTHER = 6.0
CXL_PREMIUM = 1.10


def ssd_cost(
    capacity_tb: float,
    compute_frac: float = 1.0,
    dram_gb_per_tb: float = 1.0,
    cxl: bool = False,
) -> dict:
    """BOM cost breakdown for one SSD."""
    nand = capacity_tb * 1e12 / 128e9 * NAND_PER_128GB
    dram_gb = capacity_tb * dram_gb_per_tb
    dram = dram_gb * DRAM_PER_GB
    ctrl = CONTROLLER_FULL * compute_frac
    prem = CXL_PREMIUM if cxl else 1.0
    return {
        "nand": nand,
        "dram": dram * prem,
        "controller": ctrl * prem,
        "other": OTHER,
        "total": nand + (dram + ctrl) * prem + OTHER,
    }


def platform_cost(platform_name: str, capacity_tb: float = 2.0) -> dict:
    """Per-SSD BOM for each evaluated platform (Fig. 12 uses 2 TB SSDs)."""
    if platform_name == "Conv":
        return ssd_cost(capacity_tb, 1.0, 1.0, cxl=False)
    if platform_name == "OC":
        return ssd_cost(capacity_tb, 0.15, 0.0, cxl=False)  # minimal controller
    if platform_name in ("Shrunk", "VH", "VH(ideal)"):
        return ssd_cost(capacity_tb, 0.5, 0.5, cxl=False)
    if platform_name in ("ProcH", "XBOF"):
        return ssd_cost(capacity_tb, 0.5, 0.5, cxl=True)
    raise ValueError(platform_name)


def cost_efficiency(throughput_bps: float, platform_name: str, capacity_tb: float = 2.0) -> float:
    """Bandwidth per dollar (Fig. 12 right)."""
    return throughput_bps / platform_cost(platform_name, capacity_tb)["total"]
