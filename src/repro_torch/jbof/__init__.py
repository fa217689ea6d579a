"""repro_torch.jbof — the JBOF substrate: the paper's JBOF, simulated.

Port of `repro.jbof`: the SSD model (`ssd`, Table 1 and its calibration),
the platforms of §5.1 (`platforms`), the workloads of Table 2 and their
arrival matrices (`workloads`), the BOM cost model of Fig. 12 (`bom`),
and the windowed fluid-queueing simulator (`sim.simulate`), which runs
static, trace-driven (`SimConfig(traces=...)`, one SHARDS window kernel
launch a window), multi-enclosure (`n_enclosures > 1`) and observed
(`obs=ObsConfig(enabled=True)`) runs on CUDA unless told otherwise:

    from repro_torch.jbof import platforms, sim, workloads as wl
    wls = [wl.micro(True, 64.0)] * 6 + [wl.idle()] * 6
    res = sim.simulate(platforms.xbof(), wls, wl.arrivals(wls, 400),
                       device="cpu")

`SimConfig(events=...)` drives the failure/reclaim plane: a
`core.events` schedule of lender reclaims, SSD failures and hot removals,
and enclosure drops (the streams uploaded once, sliced per window).
"""
from . import bom, platforms, sim, ssd, workloads

__all__ = ["bom", "platforms", "sim", "ssd", "workloads"]
