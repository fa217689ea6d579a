"""Input stand-ins for every (architecture x shape) cell (port of
`repro.launch.specs`).

Meta-device tensors in place of the reference's ShapeDtypeStructs: the
same shapes and dtypes, nothing allocated. This is what the dry run
(`launch.dryrun`) places on its fake mesh. The four assigned LM shapes:

    train_4k      seq 4,096   global_batch 256   (train_step)
    prefill_32k   seq 32,768  global_batch 32    (prefill)
    decode_32k    seq 32,768  global_batch 128   (serve_step: 1 new token,
                                                  KV cache of 32k)
    long_500k     seq 524,288 global_batch 1     (serve_step; sub-quadratic
                                                  archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import decode as D
from repro_torch.models.config import ArchConfig

META = torch.device("meta")


class Shape(NamedTuple):
    name: str
    seq: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (see DESIGN.md §6)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            f"{cfg.name} is pure full-attention (O(S) KV state at 512k is "
            "beyond HBM and the arch has no sub-quadratic mode) — skipped "
            "per assignment; see DESIGN.md §Arch-applicability."
        )
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_for(cfg: ArchConfig, shape: Shape) -> dict:
    """Training/prefill batch as meta tensors."""
    b, s = shape.global_batch, shape.seq
    out: dict[str, Any] = {}
    if cfg.frontend and not cfg.is_encdec:
        out["input_embeds"] = _meta((b, s, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if shape.kind == "train":
        out["targets"] = _meta((b, s), torch.int32)
    if cfg.is_encdec:
        out["enc_embeds"] = _meta((b, cfg.enc_seq, cfg.d_model), torch.float32)
    return out


def cache_specs_for(cfg: ArchConfig, shape: Shape) -> Any:
    """Decode cache as meta tensors (ring-limited for windowed archs):
    `models.decode.init_cache` on the meta device."""
    return D.init_cache(cfg, shape.global_batch, shape.seq, device=META)


def decode_inputs_for(cfg: ArchConfig, shape: Shape) -> tuple[Any, Any]:
    cache = cache_specs_for(cfg, shape)
    token = _meta((shape.global_batch,), torch.int32)
    return cache, token


def probe_variants(cfg: ArchConfig, kind: str):
    """Shallow probe configs for roofline extrapolation.

    The reference's XLA cost analysis counts each while-loop body ONCE, so
    a scanned stack's measured cost is depth-independent: measured =
    header + sum(body_k over loop INSTANCES). An unrolled probe at depth L
    instead measures header + L*body. Compiling a few (scanned, unrolled)
    shallow variants yields a linear system whose solution gives per-layer
    bodies, from which the full-depth "true" cost is reconstructed.

    Returns [(variant_cfg, coeffs)] where coeffs maps unknown name ->
    multiplier; unknowns are "header" plus per-kind layer bodies. The
    solver also needs `true_coeffs(cfg)` below.
    """
    def rep(**kw):
        return dataclasses.replace(cfg, **kw)

    if cfg.is_encdec:
        if kind == "decode":  # encoder not in the decode path
            return [
                (rep(n_layers=2), {"header": 1, "dec": 1}),
                (rep(n_layers=2, scan_unroll=True), {"header": 1, "dec": 2}),
            ]
        return [
            (rep(n_layers=2, n_enc_layers=2), {"header": 1, "enc": 1, "dec": 1}),
            (rep(n_layers=2, n_enc_layers=2, scan_unroll=True),
             {"header": 1, "enc": 2, "dec": 2}),
            (rep(n_layers=1, n_enc_layers=2, scan_unroll=True),
             {"header": 1, "enc": 2, "dec": 1}),
        ]
    if cfg.moe is not None:
        moe = cfg.moe

        def moerep(fk, m, unroll):
            return rep(n_layers=fk + m, scan_unroll=unroll,
                       moe=dataclasses.replace(moe, first_k_dense=fk))

        return [
            (moerep(1, 2, False), {"header": 1, "dense": 1, "moe": 1}),
            (moerep(1, 2, True), {"header": 1, "dense": 1, "moe": 2}),
            (moerep(2, 2, True), {"header": 1, "dense": 2, "moe": 2}),
        ]
    if cfg.pattern_period > 1:
        per = cfg.pattern_period
        n_rec_p = per - len(cfg.attn_in_period)
        n_attn_p = len(cfg.attn_in_period)
        if kind in ("decode", "prefill"):
            # hybrid decode/prefill is a python loop (always unrolled)
            return [
                (rep(n_layers=per), {"header": 1, "rec": n_rec_p, "attn": n_attn_p}),
                (rep(n_layers=2 * per),
                 {"header": 1, "rec": 2 * n_rec_p, "attn": 2 * n_attn_p}),
                (rep(n_layers=per, attn_in_period=()),
                 {"header": 1, "rec": per, "attn": 0}),
            ]
        # train: runs are scans; one pattern = 1 rec run + 1 attn run
        return [
            (rep(n_layers=per), {"header": 1, "rec": 1, "attn": 1}),
            (rep(n_layers=per, scan_unroll=True),
             {"header": 1, "rec": n_rec_p, "attn": n_attn_p}),
            (rep(n_layers=2 * per, scan_unroll=True),
             {"header": 1, "rec": 2 * n_rec_p, "attn": 2 * n_attn_p}),
        ]
    # uniform stacks (dense / vlm / ssm)
    return [
        (rep(n_layers=2), {"header": 1, "body": 1}),
        (rep(n_layers=2, scan_unroll=True), {"header": 1, "body": 2}),
    ]


def true_coeffs(cfg: ArchConfig, kind: str) -> dict:
    """Loop-body multipliers of the FULL config (per-layer counts)."""
    if cfg.is_encdec:
        if kind == "decode":
            return {"header": 1, "dec": cfg.n_layers}
        return {"header": 1, "enc": cfg.n_enc_layers, "dec": cfg.n_layers}
    if cfg.moe is not None:
        fk = cfg.moe.first_k_dense
        return {"header": 1, "dense": fk, "moe": cfg.n_layers - fk}
    if cfg.pattern_period > 1:
        kinds = cfg.layer_kinds()
        return {"header": 1,
                "rec": sum(1 for k in kinds if k == "rec"),
                "attn": sum(1 for k in kinds if k == "attn")}
    return {"header": 1, "body": cfg.n_layers}


def default_n_micro(cfg: ArchConfig, shape: Shape, n_data: int) -> int:
    """Gradient-accumulation depth: keep the per-device microbatch at 1-2
    sequences for the big configs (activation memory), shallower for small."""
    per_dev = max(shape.global_batch // max(n_data, 1), 1)
    if cfg.n_params() > 1e11:
        return per_dev          # microbatch of 1 sequence per device
    if cfg.n_params() > 1e10:
        return max(per_dev // 2, 1)
    return max(per_dev // 4, 1)
