"""The seven JBOF platforms compared in the paper (§5.1), and XBOF+.

The port's own copy of `repro.jbof.platforms` (plain Python, the same
values).

  Conv      abundant compute (6 cores, 1 GB/TB DRAM), no sharing
  OC        open-channel: minimal SSD compute, firmware + metadata on the host
  Shrunk    half compute (3 cores, 0.5 GB/TB), no sharing
  VH        Shrunk + simple SSD virtualization & harvesting (write redirect
            + copyback + centralized hypervisor management)
  VH(ideal) VH without the copyback penalty
  ProcH     Shrunk + XBOF processor harvesting only
  XBOF      Shrunk + processor harvesting + DRAM harvesting + WAL, CXL fabric
  XBOF+     XBOF + data-end (flash backbone) and CXL-link bandwidth
            harvesting through the same descriptor plane (§3 full
            disaggregation: compute-end, data-end, link)
"""
from __future__ import annotations

from typing import NamedTuple

from . import ssd


class Platform(NamedTuple):
    name: str
    cores: float = ssd.CONV_CORES
    dram_frac: float = 1.0          # fraction of the 1 GB/TB full provisioning
    harvest_proc: bool = False      # XBOF §4.4
    harvest_dram: bool = False      # XBOF §4.5
    harvest_flash: bool = False     # data-end channel-time harvesting (XBOF+)
    harvest_link: bool = False      # CXL link-byte harvesting (XBOF+)
    vh: bool = False                # simple virtualization & harvesting
    vh_copyback: bool = True        # pay copyback on reclaim (False = ideal)
    oc: bool = False                # firmware + metadata on host
    host_extra_clocks: float = 0.0  # per-command host-side platform overhead
    n_slots: int = 4                # processor descriptors per lender
    dram_slots: int = 2             # DRAM segment descriptors per lender (§4.5)
    flash_slots: int = 2            # FLASH_BW descriptors per lender (XBOF+)
    link_slots: int = 2             # LINK_BW descriptors per lender (XBOF+)
    claim_rounds: int = 4           # max lenders a borrower can harvest
    watermark: float = 0.75
    data_watermark: float = 0.95    # borrow-cancel hysteresis (see core.harvest)
    link_watermark: float = 0.98    # FLASH_BW borrow gate: link exhausted
    mgmt_interval: int = 10         # management rounds every N windows (10 ms)
    # §4.6 per-op cost-model knobs (`repro.core.costs.OP_COSTS` prices every
    # assisted op from these units): a remote assist pays `inter_ssd_op_s`
    # per dequeue/unwrap event and `cxl_hop_s` per fabric hop, and a remote
    # mapping lookup moves `remote_lookup_bytes` across the fabric (rides
    # the LINK_BW account). fig16_dram_sens sweeps cxl_hop_s and the I/O
    # size; fig19_backbone sweeps the I/O size through the whole table.
    inter_ssd_op_s: float = ssd.T_INTER_SSD_OP
    cxl_hop_s: float = ssd.T_CXL_HOP
    remote_lookup_bytes: float = 64.0
    # Inter-enclosure fabric tier (core/topology.py level "fabric"): extra
    # CXL traversals an assist pays when it leaves the enclosure for a
    # sibling JBOF, on top of the intra-enclosure §4.6 price. Default is
    # tier 2 of `core.costs.LEVEL_EXTRA_HOPS` — intra ≪ cross, which is
    # what makes `simulate(..., n_enclosures>1)` settle claims inside the
    # enclosure first and spill to the fabric only when the local pool is
    # dry. fig22_fabric sweeps it to locate where cross-fabric harvesting
    # stops paying.
    fabric_extra_hops: float = 4.0
    # Payload compression on remote transfers: page-sized payloads (remote
    # mapping lines, redirected-backbone I/O) ship payload_bytes x this
    # ratio across the fabric; command/completion descriptors never
    # compress. 0.25 models the serving substrate's int8 KV pages as a
    # cost-model parameter (fig16/fig19 sweep it); 1.0 = uncompressed.
    payload_comp_ratio: float = 1.0
    # flat-model fallback: charge the pre-refactor SYNC_*_OVERHEAD constants
    # (I/O-size-independent) instead of the per-op §4.6 table, so historical
    # fig10/fig19 baselines stay reproducible (DESIGN.md §8).
    flat_sync: bool = False

    @property
    def ssd_config(self) -> ssd.SSDConfig:
        return ssd.SSDConfig(
            cores=self.cores,
            dram_gb_per_tb=self.dram_frac * ssd.DRAM_GB_PER_TB_FULL,
            cxl=(self.harvest_proc or self.harvest_dram
                 or self.harvest_flash or self.harvest_link),
        )


def conv() -> Platform:
    return Platform("Conv")


def oc() -> Platform:
    # host DRAM (16 GB) caches metadata for 12 x 4 TB = 48 TB of flash
    host_cache_frac = 16.0 / 48.0
    return Platform(
        "OC", cores=0.0, dram_frac=host_cache_frac, oc=True,
        host_extra_clocks=ssd.C_HOST_FW,
    )


def shrunk(cores: float = ssd.SHRUNK_CORES, dram_frac: float = 0.5) -> Platform:
    return Platform("Shrunk", cores=cores, dram_frac=dram_frac)


def vh(cores: float = ssd.SHRUNK_CORES, dram_frac: float = 0.5) -> Platform:
    return Platform(
        "VH", cores=cores, dram_frac=dram_frac, vh=True,
        host_extra_clocks=ssd.C_HOST_VH,
    )


def vh_ideal(cores: float = ssd.SHRUNK_CORES, dram_frac: float = 0.5) -> Platform:
    return Platform(
        "VH(ideal)", cores=cores, dram_frac=dram_frac, vh=True,
        vh_copyback=False, host_extra_clocks=ssd.C_HOST_VH,
    )


def proch(cores: float = ssd.SHRUNK_CORES, dram_frac: float = 0.5) -> Platform:
    return Platform(
        "ProcH", cores=cores, dram_frac=dram_frac, harvest_proc=True,
        host_extra_clocks=ssd.C_HOST_LB,
    )


def xbof(cores: float = ssd.SHRUNK_CORES, dram_frac: float = 0.5) -> Platform:
    return Platform(
        "XBOF", cores=cores, dram_frac=dram_frac,
        harvest_proc=True, harvest_dram=True,
        host_extra_clocks=ssd.C_HOST_LB,
    )


def xbof_full(cores: float = ssd.SHRUNK_CORES, dram_frac: float = 0.5) -> Platform:
    """XBOF with the full §3 disaggregation: compute-end clocks, DRAM
    segments, data-end channel time AND link bytes all flow through the one
    descriptor plane (new FLASH_BW / LINK_BW rtypes)."""
    return Platform(
        "XBOF+", cores=cores, dram_frac=dram_frac,
        harvest_proc=True, harvest_dram=True,
        harvest_flash=True, harvest_link=True,
        host_extra_clocks=ssd.C_HOST_LB,
    )


ALL = {
    "Conv": conv,
    "OC": oc,
    "Shrunk": shrunk,
    "VH": vh,
    "VH(ideal)": vh_ideal,
    "ProcH": proch,
    "XBOF": xbof,
    "XBOF+": xbof_full,
}
