"""repro_torch.core — the XBOF mechanism as substrate-agnostic PyTorch
modules (port of `repro.core`).

  descriptors  idle-resource descriptor tables (paper §4.3)
  harvest      trigger conditions + the harvest state machine (§4.4/§4.5)
  manager      the unified management round every substrate runs
  loadbalance  holistic load-balance formula (paper §4.4)
  wal          log-page crash consistency (paper §4.5)
  topology     the exchange tree and its level-by-level exchange (DESIGN.md §11)
  costs        per-op §4.6 remote-assist price table
  shards_mrc   SHARDS online miss-ratio-curve estimation (§4.5)
  events       failure/reclaim event schedules shared by both substrates
"""
from . import (costs, descriptors, events, harvest, loadbalance, manager,
               shards_mrc, topology, wal)

__all__ = ["costs", "descriptors", "events", "harvest", "loadbalance",
           "manager", "shards_mrc", "topology", "wal"]
