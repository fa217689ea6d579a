"""The reduction of the paged decode-attention kernel
(`csrc/paged_attention.cu`), emulated in plain PyTorch on the CPU and held
against the port's plain versions (`repro_torch.kernels.ref.paged_attention`
/ `paged_attention_quant`), the JAX Pallas kernel in interpret mode
(`repro.kernels.paged_attention`) and the JAX oracle (`repro.kernels.ref`)
on the same seeded numpy inputs.

The kernel runs a unit (row, KV head) with nw warps. A row with a valid
slot: its tokens below the length go in chunks of tc (what fits 4 KB of K
and V, by the C entry's rule), chunk c to warp c mod nw; each warp runs
its own online softmax (m, l, acc) over groups of 4 tokens of a chunk
(one max and one rescale a group; holes, slots past the length and past
the chunk weigh 0), and the warps merge in warp order. A row with no
valid slot: no q, no K; the mean of V over all mp * page gathered rows
(holes read page 0), as fixed-order partial sums: per column,
rows_per_pass row slots each summing its rows in order, combined by a
halving tree, times the page's v_scale (int8); the warp's columns (j mod
nw) in order; the warps in order. The emulation does the same, so it
checks the reduction the kernel runs; the kernel repeats it on the card
(tests/test_torch_cuda_kernels.py). It lives here and not in the
package: the kernel is the package's form of it.

Shapes: the sweeps of tests/test_kernels.py; a cut-down form of the
engine step's pattern (48 rows at qwen3-14b's width, over half of length
0 with all-hole tables, one-page rows, one of exactly 16 tokens and one
of 17); length-0 rows with stale page ids; pages of 1 slot; group 8 with
head_dim 256; head_dim 36 (bf16 rows of 72 bytes); full rows with holes.
For the Pallas kernel, max_pages is a multiple of its page block, so its
length-0 rows average over the same columns. Gates: fp32 3e-5, bf16 3e-2,
int8 1e-5 (those of tests/test_kernels.py). Last, the byte count of
`chip_smoke.py`'s bound for the paged rows."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_pa
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

NEG_INF = -1e30
TOL = {"float32": 3e-5, "bfloat16": 3e-2, "int8": 1e-5}
STAGE_BYTES = 4096   # K + V bytes of a ring stage, as the kernel's
BLOCK_DIMS = 128     # output dims per unit

SHAPES = {  # (b, h, kv, d, page, mp, pool, pattern)
    "sweep0": (2, 4, 2, 128, 8, 6, 16, "sweep"),
    "sweep1": (1, 8, 8, 128, 16, 4, 8, "sweep"),
    "sweep2": (3, 2, 1, 256, 8, 3, 12, "sweep"),
    "main48": (48, 40, 8, 128, 16, 8, 96, "main"),
    "stale": (8, 8, 2, 128, 16, 8, 40, "stale"),
    "page1": (6, 8, 4, 64, 1, 20, 64, "holes"),
    "group8-d256": (4, 16, 2, 256, 16, 4, 16, "holes"),
    "d36": (5, 4, 2, 36, 8, 5, 20, "holes"),
    "full": (3, 40, 8, 128, 16, 8, 32, "full"),
}
# shapes whose length-0 rows the Pallas kernel averages as the oracle does
# (max_pages a multiple of its page block) or that have none
PALLAS = ["sweep0", "sweep1", "sweep2", "main48", "stale"]


def stage_tokens(d, sz):
    """Tokens per ring stage: the C entry's tc."""
    dq = -(-d // 4) * 4
    return max(1, min(32, STAGE_BYTES // (d * sz + min(dq, BLOCK_DIMS) * sz)))


def rows_per_pass(d, sz):
    """Row slots of the mean path: 32 lanes over 16-byte chunks (or the
    widest copy the row pitch allows) of a 128-dim block."""
    vb = 16
    while vb > sz and (d * sz) % vb:
        vb //= 2
    chunks = BLOCK_DIMS // (vb // sz)
    return max(1, 32 // chunks)


def split_attention(q, k_pool, v_pool, table, lengths, k_scale=None,
                    v_scale=None, nw=1):
    """The kernel's reduction: q [B, H, D] (fp32 or bf16; fp32 for int8
    pools), pools [P, page, KV, D], table int32 [B, mp], lengths int32 [B]
    -> [B, H, D] in q's dtype; nw warps per unit."""
    b, h, d = q.shape
    n_pages, page, kv, _ = k_pool.shape
    mp = table.shape[1]
    g = h // kv
    quant = k_scale is not None
    sz = k_pool.element_size()
    tc = stage_tokens(d, sz)
    rpw = rows_per_pass(d, sz)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    qf = q.float().reshape(b, kv, g, d)
    kf, vf = k_pool.float(), v_pool.float()
    out = torch.empty((b, kv, g, d))
    for i in range(b):
        n = max(int(lengths[i]), 0)
        row = [int(x) for x in table[i]]
        live = min(mp, -(-n // page))
        if any(row[j] >= 0 for j in range(live)):
            n_tok = min(n, mp * page)
            n_chunks = -(-n_tok // tc)
            parts = []
            for w in range(nw):
                m = torch.full((kv, g), NEG_INF)
                l = torch.zeros((kv, g))
                acc = torch.zeros((kv, g, d))
                for c in range(w, n_chunks, nw):
                    for g0 in range(0, tc, 4):
                        group = []   # (score, page, slot) of the group's valid tokens
                        for tok in range(c * tc + g0, c * tc + min(g0 + 4, tc)):
                            j, t = divmod(tok, page)
                            if tok >= n_tok or row[j] < 0:
                                continue
                            safe = min(row[j], n_pages - 1)
                            s = torch.einsum("kgd,kd->kg", qf[i], kf[safe, t])
                            s = s * (k_scale[safe] * scale) if quant else s * scale
                            group.append((s, safe, t))
                        if not group:
                            continue
                        mn = torch.maximum(m, torch.stack([s for s, _, _ in group]).amax(0))
                        alpha = torch.exp(m - mn)
                        ps = torch.zeros((kv, g))
                        acc = acc * alpha[..., None]
                        for s, safe, t in group:
                            p = torch.exp(s - mn)
                            ps = ps + p
                            pv = p * v_scale[safe] if quant else p
                            acc = acc + pv[..., None] * vf[safe, t][:, None, :]
                        l = l * alpha + ps
                        m = mn
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            lsum, a = torch.zeros((kv, g)), torch.zeros((kv, g, d))
            for m, l, acc in parts:
                c = torch.exp(m - mx)
                lsum = lsum + l * c
                a = a + acc * c[..., None]
            out[i] = a / torch.clamp(lsum, min=1e-30)[..., None]
        else:
            total = torch.zeros((kv, d))
            for w in range(nw):
                acc = torch.zeros((kv, d))
                for j in range(w, mp, nw):
                    safe = min(max(row[j], 0), n_pages - 1)
                    slots = []
                    for rs in range(rpw):
                        x = torch.zeros((kv, d))
                        for t in range(rs, page, rpw):
                            x = x + vf[safe, t]
                        slots.append(x)
                    o = rpw // 2
                    while o:
                        slots = [slots[r] + slots[r + o] for r in range(o)]
                        o //= 2
                    col = slots[0] * v_scale[safe] if quant else slots[0]
                    acc = acc + col
                total = total + acc
            mean = total / torch.tensor(float(mp * page), dtype=torch.float32)
            out[i] = mean[:, None, :].expand(kv, g, d)
    return out.reshape(b, h, d).to(q.dtype)


def _tables(rng, b, mp, pool, page, pattern):
    """Page tables and lengths: "sweep", tests/test_kernels.py's (no holes,
    no length 0); "holes", a hole inside the live range of every other row
    and the last row of length 0; "main", the engine step's; "stale",
    every other row of length 0 with stale page ids; "full", mp pages with
    2 holes, the length inside the last page."""
    pt = np.full((b, mp), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    for i in range(b):
        if pattern == "full":
            pt[i] = rng.choice(pool, mp, replace=False)
            pt[i, rng.choice(mp, 2, replace=False)] = -1
            lens[i] = (mp - 1) * page + int(rng.integers(1, page + 1))
            continue
        n = int(rng.integers(1, mp + 1))
        pt[i, :n] = rng.choice(pool, n, replace=False)
        lens[i] = int(rng.integers(1, n * page + 1))
        if pattern != "sweep" and n > 1 and i % 2 == 0:
            pt[i, rng.integers(0, n - 1)] = -1
    if pattern == "main":
        pt[:] = -1
        pt[:, 0] = rng.integers(0, pool, b)
        lens = rng.integers(1, page + 1, b).astype(np.int32)
        idle = np.arange(b) % 16 < 9
        pt[idle], lens[idle] = -1, 0
        lens[1], lens[2] = page, page + 1
        pt[2, 1] = (pt[2, 0] + 1) % pool
    elif pattern == "stale":
        lens[::2] = 0
        pt[::2] = rng.integers(0, pool, pt[::2].shape)
    if pattern != "sweep":
        lens[-1] = 0
    return pt, lens


def _inputs(name, form, seed):
    """numpy fp32 draws; int8 pools quantized per page as kv_pool does.
    Returns (torch args, torch kwargs, jax args, jax kwargs)."""
    b, h, kv, d, page, mp, pool, pattern = SHAPES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    planes = [rng.standard_normal((pool, page, kv, d)).astype(np.float32)
              for _ in range(2)]
    pt, lens = _tables(rng, b, mp, pool, page, pattern)
    if form == "int8":
        scales = [(np.abs(x).max(axis=(1, 2, 3)) / 127.0).astype(np.float32)
                  for x in planes]
        planes = [np.clip(np.round(x / s[:, None, None, None]), -127, 127).astype(np.int8)
                  for x, s in zip(planes, scales)]
        targs = [torch.from_numpy(a) for a in (q, *planes, pt, lens)]
        tkw = dict(k_scale=torch.from_numpy(scales[0]), v_scale=torch.from_numpy(scales[1]))
        jargs = [jnp.asarray(a) for a in (q, *planes, pt, lens)]
        jkw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
        return targs, tkw, jargs, jkw
    td, jd = getattr(torch, form), getattr(jnp, form)
    targs = [torch.from_numpy(a).to(td) for a in (q, *planes)] + [
        torch.from_numpy(pt), torch.from_numpy(lens)]
    jargs = [jnp.asarray(a, jd) for a in (q, *planes)] + [jnp.asarray(pt), jnp.asarray(lens)]
    return targs, {}, jargs, {}


def _plain(targs, tkw):
    if tkw:
        q, k, v, pt, lens = targs
        return tref.paged_attention_quant(q, k, v, tkw["k_scale"], tkw["v_scale"], pt, lens)
    return tref.paged_attention(*targs)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("nw", [1, 2, 4])
@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_split_matches_plain_version(name, form, nw):
    targs, tkw, _, _ = _inputs(name, form, seed=len(name))
    got = split_attention(*targs, **tkw, nw=nw)
    want = _plain(targs, tkw)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want.float(), TOL[form])


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", PALLAS)
def test_split_matches_pallas_and_oracle(name, form):
    targs, tkw, jargs, jkw = _inputs(name, form, seed=len(name) + 1)
    got = split_attention(*targs, **tkw, nw=4 if name == "main48" else 1)
    if form == "int8":
        q, k, v, pt, lens = jargs
        oracle = jref.paged_attention_quant(q, k, v, jkw["k_scale"], jkw["v_scale"], pt, lens)
    else:
        oracle = jref.paged_attention(*jargs)
    _close(got, oracle, TOL[form])
    _close(got, pallas_pa(*jargs, **jkw, interpret=True), TOL[form])


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
def test_rows_without_a_valid_slot_read_no_q_and_no_k(form):
    """The mean path reads neither q nor K: with both NaN, the rows of
    length 0 and the all-hole rows still give the plain version's mean."""
    targs, tkw, _, _ = _inputs("stale", form, seed=5)
    q, k, v, pt, lens = targs
    want = _plain(targs, tkw)
    nan_q = torch.full_like(q, float("nan"))
    nan_k = (torch.full_like(k, float("nan")) if k.is_floating_point()
             else k)  # int8 codes have no NaN: their scales do
    kw = dict(tkw)
    if form == "int8":
        kw["k_scale"] = torch.full_like(tkw["k_scale"], float("nan"))
    got = split_attention(nan_q, nan_k, v, pt, lens, **kw, nw=2)
    idle = lens == 0
    assert bool(idle.any())
    _close(got[idle], want[idle].float(), TOL[form])
    assert bool(torch.isnan(got[~idle].float()).all())


def test_stage_and_pass_shapes_at_the_engine_width():
    """At head_dim 128 a stage holds 4 fp32, 8 bf16 or 16 int8 tokens (an
    engine page of 16 int8 tokens is one stage), and the mean path sums 1,
    2 or 4 rows at once with 16-byte loads."""
    assert [stage_tokens(128, sz) for sz in (4, 2, 1)] == [4, 8, 16]
    assert [rows_per_pass(128, sz) for sz in (4, 2, 1)] == [1, 2, 4]
    # rows off 16 bytes take the widest copy their pitch allows
    assert rows_per_pass(36, 2) == 1 and rows_per_pass(36, 1) == 1


@pytest.mark.parametrize("form", ["float32", "int8"])
def test_bound_counts_the_tokens_below_each_length(form):
    """`chip_smoke.work`, the paged rows' bound: K and V rows of the tokens
    below each row's length (a page read by two rows counts its longest
    prefix once), every V row of the pages a length-0 row averages (holes
    read page 0), one scale per page and plane for int8."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    page, kv, d, h = 4, 2, 8, 4
    dt = torch.int8 if form == "int8" else torch.float32
    pool = torch.zeros((8, page, kv, d), dtype=dt)
    table = torch.tensor([[3, 5], [3, -1], [-1, 7]], dtype=torch.int32)
    lengths = torch.tensor([6, 3, 0], dtype=torch.int32)
    q = torch.zeros((3, h, d))
    kw = dict(k_scale=torch.ones(8), v_scale=torch.ones(8)) if form == "int8" else {}
    nbytes, flops = chip_smoke.work([q, pool, pool, table, lengths], kw)
    k_tokens = 4 + 2                 # page 3 (longest prefix 4), page 5 (2)
    v_tokens = k_tokens + 4 + 4      # and all of pages 0 and 7 for row 2
    scales = (2 + 4) * 4 if form == "int8" else 0
    rest = (2 + 3) * h * d * 4 + (2 + 1 + 2) * 4 + 3 * 4   # q, out, table, lengths
    assert nbytes == (k_tokens + v_tokens) * kv * d * pool.element_size() + scales + rest
    assert flops == 4 * h * d * (6 + 3) + kv * d * 2 * page
