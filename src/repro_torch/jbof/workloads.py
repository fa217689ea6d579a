"""Workload synthesis (paper Table 2 + §2.2 burstiness).

Each workload is characterized exactly as in Table 2 (read ratio, average
read/write sizes) plus two synthesis parameters: a burst duty cycle /
intensity (the paper's sporadic-burst premise: demand exceeds device capacity
only during bursts) and a mapping-table locality profile that yields the
MRC shapes of Fig. 4c.

Arrival matrices are generated *outside* the simulator's window loop
(deterministic, seeded) as float32[T, n_ssd, 2] byte demands per window.

The port's own copy of `repro.jbof.workloads`: `arrivals` makes the same
seeded `np.random` calls, so its array is the reference's bit for bit; it
returns NumPy, and the caller moves the array to a device. `mrc_curve`
takes and returns tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import ssd


class Workload(NamedTuple):
    name: str
    read_ratio: float         # fraction of bytes that are reads (Table 2)
    read_kb: float             # average read size (Table 2)
    write_kb: float            # average write size (Table 2)
    intensity: float = 3.0     # demand / capacity during a burst
    duty: float = 0.25         # fraction of windows that are bursting
    base_load: float = 0.15    # off-burst demand / capacity
    qd: float = 64.0           # I/O depth (closed-loop outstanding commands)
    # MRC profile: miss(c) = cold + (1-cold) * (1 + c/c0)^(-beta)
    # with c the cache size as a fraction of the full mapping table.
    mrc_c0: float = 0.05
    mrc_beta: float = 1.2
    mrc_cold: float = 0.01
    # spatial locality of mapping-table lookups: fraction of commands whose
    # mapping page is NOT shared with the previous command. Sequential
    # streams revisit the same 16 KB mapping page (4096 entries = 16 MB of
    # logical span), so their effective lookup rate is tiny; random 4 KB
    # access pays one independent lookup per command. Cloud traces are
    # mixed — default 0.2 (calibrated against Fig. 11's Shrunk loss).
    locality: float = 0.2
    uniform_mrc: bool = False  # uniform-random MRC: miss = 1 - cache_frac


# Table 2, verbatim characteristics. Locality/burst parameters chosen so the
# reproduction benchmarks land the paper's aggregate claims (see EXPERIMENTS).
TABLE2: dict[str, Workload] = {
    "src":       Workload("src",       0.113,  8.1,   7.1, intensity=3.5, duty=0.3,  mrc_c0=0.04, mrc_beta=1.4),
    "DAP":       Workload("DAP",       0.562, 62.1,  97.2, intensity=3.0, duty=0.25, mrc_c0=0.06, mrc_beta=1.1),
    "MSNFS":     Workload("MSNFS",     0.672,  9.6,  11.1, intensity=3.0, duty=0.25, mrc_c0=0.05, mrc_beta=1.2),
    "mds":       Workload("mds",       0.928, 60.1,  13.8, intensity=3.2, duty=0.25, mrc_c0=0.07, mrc_beta=1.0),
    "YCSB-A":    Workload("YCSB-A",    0.980,  9.5, 743.3, intensity=3.0, duty=0.3,  mrc_c0=0.03, mrc_beta=1.5),
    "Fuji-0":    Workload("Fuji-0",    0.827, 35.7,  10.7, intensity=3.0, duty=0.25, mrc_c0=0.05, mrc_beta=1.2),
    "Fuji-1":    Workload("Fuji-1",    0.863, 32.7,  13.3, intensity=3.0, duty=0.25, mrc_c0=0.05, mrc_beta=1.2),
    "Fuji-2":    Workload("Fuji-2",    0.876, 39.3,   6.7, intensity=3.0, duty=0.25, mrc_c0=0.05, mrc_beta=1.2),
    "Tencent-0": Workload("Tencent-0", 0.843, 31.2,   8.8, intensity=3.2, duty=0.25, mrc_c0=0.001, mrc_beta=2.5),
    "Tencent-1": Workload("Tencent-1", 0.020, 12.5, 289.5, intensity=3.5, duty=0.35, mrc_c0=0.02, mrc_beta=1.6),
    "Tencent-2": Workload("Tencent-2", 0.982, 47.0,   7.0, intensity=3.0, duty=0.25, mrc_c0=0.01, mrc_beta=2.0),
    "Ali-0":     Workload("Ali-0",     0.981, 37.0,  16.8, intensity=3.5, duty=0.45, mrc_c0=0.17, mrc_beta=0.9),
    "Ali-1":     Workload("Ali-1",     0.813, 370.4, 394.5, intensity=2.8, duty=0.25, mrc_c0=0.08, mrc_beta=1.0),
    "Ali-2":     Workload("Ali-2",     0.110, 26.0,  30.0, intensity=3.2, duty=0.3,  mrc_c0=0.05, mrc_beta=1.3),
}

REAL_WORKLOADS = list(TABLE2)


def micro(read: bool, io_kb: float, qd: int = 64, random_access: bool = False) -> Workload:
    """Microbenchmark: fixed-size, single-direction (§5.2).

    Sequential micro (Fig 9): near-zero mapping-lookup rate (one 16 KB
    mapping page covers a 16 MB logical span).
    Random 4 KB micro (Fig 10): uniform MRC over the full table, one lookup
    per command — this is what makes miss ratio = 1 - cache_fraction,
    matching the paper's 49.7% (0.5 GB/TB) and 66.2% (host-cached) points.
    """
    return Workload(
        name=f"{'rand' if random_access else 'seq'}-{'read' if read else 'write'}{int(io_kb)}K-qd{qd}",
        read_ratio=1.0 if read else 0.0,
        read_kb=io_kb,
        write_kb=io_kb,
        intensity=4.0 if qd >= 32 else 0.05 * qd,  # QD64 saturates; QD1 doesn't
        duty=1.0,
        base_load=0.0,
        qd=float(qd),
        mrc_c0=0.08,
        mrc_beta=1.1,
        locality=1.0 if random_access else io_kb * 1024.0 / (16 * 1024 * 1024),
        uniform_mrc=random_access,
    )


def idle() -> Workload:
    return Workload("idle", 0.5, 8.0, 8.0, intensity=0.0, duty=0.0, base_load=0.02, qd=1.0)


def moderate(read: bool = False, io_kb: float = 4.0, qd: int = 8) -> Workload:
    """Lender-side moderate traffic for the Fig 13 interaction study."""
    load = min(0.028 * qd, 0.9)
    return Workload(
        f"moderate-qd{qd}", 1.0 if read else 0.0, io_kb, io_kb,
        intensity=load, duty=1.0, base_load=0.0, qd=float(qd),
        locality=io_kb * 1024.0 / (16 * 1024 * 1024),
    )


def mrc_curve(w: Workload, cache_frac) -> torch.Tensor:
    """Parametric miss-ratio curve (Fig 4c family).

    ``cache_frac``: cache size as a fraction of the full mapping table
    (a tensor, or anything `torch.as_tensor` takes; float32 out, on the
    input's device). Monotone non-increasing, miss(0)=1, asymptote =
    cold-miss floor.
    """
    c = torch.clamp(torch.as_tensor(cache_frac, dtype=torch.float32), min=0.0)
    warm = torch.pow(1.0 + c / w.mrc_c0, -w.mrc_beta)
    return torch.clamp(w.mrc_cold + (1.0 - w.mrc_cold) * warm, 0.0, 1.0)


def capacity_bps(w: Workload) -> float:
    """Rough per-SSD byte capacity for this workload mix (for scaling demand)."""
    r = w.read_ratio
    return r * ssd.PEAK_READ_BPS + (1 - r) * ssd.PEAK_WRITE_BPS


def arrivals(
    workloads: list[Workload],
    n_windows: int,
    window_s: float = 1e-3,
    seed: int = 0,
    phase_stagger: bool = True,
) -> np.ndarray:
    """float32[T, n_ssd, 2] — (read_bytes, write_bytes) demand per window.

    Burst process: each SSD alternates base-load and burst phases; phases are
    staggered across SSDs (the paper's premise: tenants burst at *different
    times*, §2.2) with pseudo-random jitter on burst onset and length.
    """
    n = len(workloads)
    rng = np.random.default_rng(seed)
    out = np.zeros((n_windows, n, 2), np.float32)
    for i, w in enumerate(workloads):
        cap = capacity_bps(w) * window_s
        if w.duty >= 1.0 - 1e-6:  # steady microbenchmark
            on = np.ones(n_windows, bool)
        else:
            period = max(int(n_windows * 0.2), 8)
            burst_len = max(int(period * w.duty), 1)
            offset = (i * period) // max(n, 1) if phase_stagger else 0
            offset += int(rng.integers(0, max(period // 4, 1)))
            t = (np.arange(n_windows) + offset) % period
            on = t < burst_len
        level = np.where(on, w.intensity, w.base_load).astype(np.float32)
        level = level * rng.lognormal(0.0, 0.08, n_windows).astype(np.float32)
        total = level * cap
        out[:, i, 0] = total * w.read_ratio
        out[:, i, 1] = total * (1.0 - w.read_ratio)
    return out


def mean_cmd_bytes(w: Workload) -> tuple[float, float]:
    return w.read_kb * 1024.0, w.write_kb * 1024.0
