"""Host-side export: JSON-lines and Chrome-trace/perfetto rendering.

Port of `repro.obs.export`. `to_perfetto` emits the Chrome trace-event
JSON flavor that ui.perfetto.dev ingests directly: one process per
substrate scope, one thread track per node, "X" complete events for grant
lifetimes (claim -> release, publish -> withdraw), instant events for
unclosed grants, and "C" counter tracks for every ring metric.
Timestamps are window indices scaled by `window_us`. The text equals the
reference's for the same inputs.

`annotate` / `scope` open `torch.profiler.record_function` ranges, so a
captured profile labels the engine's phases (the step's `obs_record`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

# Lifecycle pairing: an opener event and the closer that ends its span.
_SPAN_PAIRS = {"claim": "release", "publish": "withdraw"}


def annotate(name: str):
    """Host-side profiler range (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


def scope(name: str):
    """A named range inside the step (`torch.profiler.record_function`:
    the port has no traced program to scope, so both hooks are one)."""
    return torch.profiler.record_function(name)


def metrics_jsonl(history: dict, totals: dict | None = None) -> str:
    """One JSON object per (metric, window); totals get `"window": null`."""
    lines = []
    for name in sorted(history):
        series = np.asarray(history[name])
        for w, row in enumerate(series):
            lines.append(
                json.dumps(
                    {"metric": name, "window": w, "values": np.asarray(row).tolist()}
                )
            )
    for name in sorted(totals or {}):
        lines.append(
            json.dumps(
                {
                    "metric": name,
                    "window": None,
                    "total": np.asarray(totals[name]).tolist(),
                }
            )
        )
    return "\n".join(lines) + "\n" if lines else ""


def events_jsonl(records: list) -> str:
    return "\n".join(json.dumps(r) for r in records) + "\n" if records else ""


def _pair_spans(records: list, t_end: float):
    """Greedy claim->release / publish->withdraw pairing per
    (event kind, rtype, level, lender, borrower-or-lender) key."""
    spans, open_by_key = [], {}
    for rec in records:
        ev = rec["event"]
        if ev in _SPAN_PAIRS:
            key = (ev, rec["rtype"], rec["level"], rec["lender"], rec["borrower"])
            open_by_key.setdefault(key, []).append(rec)
        else:
            for opener, closer in _SPAN_PAIRS.items():
                if ev != closer:
                    continue
                key = (opener, rec["rtype"], rec["level"], rec["lender"],
                       rec["borrower"])
                stack = open_by_key.get(key)
                if stack:
                    spans.append((stack.pop(), rec["t"]))
    for stack in open_by_key.values():
        for rec in stack:
            spans.append((rec, t_end))
    return spans


def to_perfetto(history: dict | None = None, records: list | None = None, *,
                window_us: float = 1000.0, substrate: str = "engine",
                t_end: float | None = None) -> dict:
    """Build a Chrome-trace dict; `json.dump` it for ui.perfetto.dev."""
    ev: list[dict] = []
    pid_main, pid_xch = 1, 2
    ev.append({"ph": "M", "pid": pid_main, "name": "process_name",
               "args": {"name": f"xbof-{substrate}"}})
    ev.append({"ph": "M", "pid": pid_xch, "name": "process_name",
               "args": {"name": f"xbof-{substrate}-exchange"}})

    records = records or []
    if t_end is None:
        t_end = max([r["t"] + 1 for r in records], default=0)
        for series in (history or {}).values():
            t_end = max(t_end, len(series))

    tids = set()
    for rec, close_t in _pair_spans(records, t_end):
        pid = pid_main if rec["level"] == 0 else pid_xch
        tids.add((pid, rec["lender"]))
        peer = "" if rec["borrower"] is None else f" -> {rec['borrower']}"
        ev.append({
            "ph": "X", "pid": pid, "tid": rec["lender"],
            "ts": rec["t"] * window_us,
            "dur": max(close_t - rec["t"], 0.25) * window_us,
            "name": f"{rec['event']} {rec['rtype']}{peer}",
            "cat": rec["rtype"],
            "args": {"amount": rec["amount"], "price": rec["price"],
                     "level": rec["level"]},
        })
    for rec in records:
        if rec["event"] in ("assist", "fabric_grant"):
            tids.add((pid_xch, rec["lender"]))
            ev.append({
                "ph": "X", "pid": pid_xch, "tid": rec["lender"],
                "ts": rec["t"] * window_us, "dur": 0.5 * window_us,
                "name": f"{rec['event']} {rec['rtype']} -> {rec['borrower']}",
                "cat": rec["rtype"],
                "args": {"amount": rec["amount"], "price": rec["price"],
                         "level": rec["level"]},
            })
    for pid, tid in sorted(tids):
        scope_name = "node" if pid == pid_main else "peer"
        ev.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                   "args": {"name": f"{scope_name} {tid}"}})

    for name in sorted(history or {}):
        series = np.asarray(history[name])
        for w, row in enumerate(series):
            flat = np.asarray(row, dtype=np.float64).reshape(-1)
            ev.append({
                "ph": "C", "pid": pid_main, "name": name, "ts": w * window_us,
                "args": {"total": float(flat.sum())},
            })
    return {"displayTimeUnit": "ms", "traceEvents": ev}


def write_report(outdir, history, totals, records, *, window_us=1000.0,
                 substrate="engine"):
    """Write metrics.jsonl + events.jsonl + trace.perfetto.json; returns
    the perfetto path."""
    import os

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{substrate}_metrics.jsonl"), "w") as f:
        f.write(metrics_jsonl(history, totals))
    with open(os.path.join(outdir, f"{substrate}_events.jsonl"), "w") as f:
        f.write(events_jsonl(records))
    trace_path = os.path.join(outdir, f"{substrate}_trace.perfetto.json")
    with open(trace_path, "w") as f:
        json.dump(to_perfetto(history, records, window_us=window_us,
                              substrate=substrate), f)
    return trace_path
