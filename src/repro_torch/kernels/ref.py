"""Plain PyTorch versions of the port's kernels — the semantics contract.

Port of `repro.kernels.ref`: prefill attention (dense and chunked
forms), decode attention, paged attention, the RG-LRU and RWKV6
recurrences with their single decode steps, the FTL lookup, the MoE
top-k router and the SHARDS window scan of the telemetry plane; and the
gradients of prefill attention, the two recurrences and the router
(autograd of the plain forward, the reference's training gradient),
which the backward kernels are held against. The CPU path runs these;
on the GPU `chip_smoke.py` and the CUDA tests hold each kernel against
them on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


# ------------------------------------------------------------- attention
# Above this key length the plain version switches to the chunked
# online-softmax form: O(S * CHUNK) live bytes instead of O(S * T).
CHUNKED_THRESHOLD = 4096
CHUNK = 1024


def check_mask_args(causal: bool, window: int) -> None:
    """The reference applies a sliding window only under ``causal`` in its
    dense form and regardless of it in its chunked form and its Pallas
    kernel; no caller asks for a window without causality, so the port
    refuses that combination instead of picking one reading."""
    if window and not causal:
        raise ValueError(
            "a sliding window needs causal=True (the reference's dense and "
            "chunked forms disagree on causal=False with window > 0)")


def refuse_grad(name: str, *tensors) -> None:
    """A CUDA wrapper raises when grad mode is on and a floating input
    needs a gradient: its output, filled through ctypes, would leave the
    autograd graph without a word. A kernel with a backward kernel carries
    its gradient in an autograd Function that calls the wrapper with grad
    mode off (the name says which); the others have none yet."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise NotImplementedError(f"later slice: no backward kernel for {name}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """Grouped-query prefill attention; optional causal mask and sliding
    window. q [B, S, H, Dh]; k, v [B, T, KV, Dh]; query row i sits at key
    position i + T - S. Masked scores take the finite NEG_INF, so a row
    with no valid key (causal, S > T) averages V over all T keys. Returns
    [B, S, H, Dh] in q's dtype."""
    t = k.shape[1]
    if t >= CHUNKED_THRESHOLD and t % CHUNK == 0:
        return attention_chunked(q, k, v, causal=causal, window=window, scale=scale)
    return attention_dense(q, k, v, causal=causal, window=window, scale=scale)


def _band(rows: torch.Tensor, cols: torch.Tensor, causal: bool, window: int):
    """Valid (query position, key position) pairs of the causal band."""
    mask = torch.ones(rows.shape[0], cols.shape[0], dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask &= cols[None, :] <= rows[:, None]
    if window:
        mask &= cols[None, :] > rows[:, None] - window
    return mask


def attention_stats(q, k, causal=True, window=0, scale=None):
    """The softmax statistics the flash forward saves for its backward:
    float32 [2, B, H, S], per query row m = the max of its masked scaled
    scores x (x = q.k * scale in fp32 of the widened inputs, NEG_INF where
    masked) and l = sum over the T keys of exp(x - m), in natural units.
    A row with no valid key (causal, S > T) has m = NEG_INF and l = T: m
    and l stay apart, since NEG_INF + log(T) rounds to NEG_INF in fp32.
    The plain version of `flash_attention(..., stats=)`."""
    check_mask_args(causal, window)
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qg = q.float().reshape(b, s, kv, h // kv, dh)
    qpos = torch.arange(s, device=q.device) + (t - s)
    m = torch.empty((b, kv, h // kv, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    for start in range(0, s, CHUNK):          # [.., CHUNK, T] scores at a time
        rows = slice(start, start + CHUNK)
        sc = torch.einsum("bskgd,btkd->bkgst", qg[:, rows], k.float()) * scale
        if causal:
            band = _band(qpos[rows], torch.arange(t, device=q.device), causal, window)
            sc = torch.where(band, sc, NEG_INF)
        m[..., rows] = sc.amax(dim=-1)
        l[..., rows] = torch.exp(sc - m[..., rows, None]).sum(dim=-1)
    return torch.stack([m, l]).reshape(2, b, h, s)


def attention_bwd(q, k, v, o, stats, dout, causal=True, window=0, scale=None):
    """The gradients (dq, dk, dv) of `attention`(q, k, v) under the
    cotangent ``dout``: torch.autograd.grad through the plain forward,
    which it recomputes (``o``, the forward's output, and ``stats``, its
    softmax statistics, are taken for the backward kernel's signature and
    not read). The plain version of
    `kernels.flash_attention.flash_attention_bwd`; the tests and
    `chip_smoke.py` hold the kernel against it, the main path never runs
    it."""
    del o, stats
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention(*leaves, causal=causal, window=window, scale=scale)
        return torch.autograd.grad(out, leaves, dout)


def attention_dense(q, k, v, causal=True, window=0, scale=None):
    check_mask_args(causal, window)
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(b, s, kv, group, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) * scale
    if causal:
        qpos = torch.arange(s, device=q.device) + (t - s)
        mask = _band(qpos, torch.arange(t, device=q.device), causal, window)
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, dh)


def attention_chunked(q, k, v, causal=True, window=0, scale=None):
    """Online softmax over key chunks of CHUNK: never holds the [S, T]
    scores (peak [S, CHUNK]). Needs T % CHUNK == 0."""
    check_mask_args(causal, window)
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(b, s, kv, group, dh)
    qpos = torch.arange(s, device=q.device) + (t - s)
    m = torch.full((b, kv, group, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, group, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, group, s, dh), dtype=torch.float32, device=q.device)
    for start in range(0, t, CHUNK):
        kb, vb = k[:, start:start + CHUNK], v[:, start:start + CHUNK]
        sc = (torch.einsum("bskgd,btkd->bkgst", qg, kb) * scale).float()
        kpos = torch.arange(start, start + CHUNK, device=q.device)
        sc = torch.where(_band(qpos, kpos, causal, window), sc, NEG_INF)
        m_cur = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(sc - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vb.dtype), vb)
        acc = acc * alpha[..., None] + pv.float()
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """One decode token per sequence against a KV cache: q [B, 1, H, Dh];
    k, v [B, S_max, KV, Dh]; valid [S_max] bool. Returns [B, 1, H, Dh]."""
    b, _, h, dh = q.shape
    kv = k.shape[2]
    group = h // kv
    qg = q.reshape(b, kv, group, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k) * dh ** -0.5
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", w, v)
    return out.reshape(b, 1, h, dh)


def _gather(page_table: torch.Tensor, lengths: torch.Tensor, n_pages: int,
            page: int):
    """Clipped page ids [B, mp] and the token validity mask [B, mp*page]:
    a slot is valid when it lies below the sequence length and its page
    is mapped. Holes (-1) clip to page 0 and mask out."""
    mp = page_table.shape[1]
    safe = page_table.long().clamp(0, n_pages - 1)
    pos = torch.arange(mp * page, device=page_table.device)[None, :]
    valid = (pos < lengths[:, None]) & (
        page_table >= 0).repeat_interleave(page, dim=1)
    return safe, valid


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q [B, H, Dh] (one decode token per sequence); k_pool/v_pool [P, page,
    KV, Dh]; page_table [B, max_pages] int32 physical page ids (-1 = hole);
    lengths [B] int32. Grouped-query attention (group = H / KV), scale
    Dh^-0.5, masked scores at the finite NEG_INF — so a row with no valid
    slot averages V over every gathered row, as the reference does.
    Returns [B, H, Dh] in q's dtype.
    """
    b, h, dh = q.shape
    p, page, kv, _ = k_pool.shape
    mp = page_table.shape[1]
    group = h // kv
    safe, valid = _gather(page_table, lengths, p, page)
    kg = k_pool[safe].reshape(b, mp * page, kv, dh)
    vg = v_pool[safe].reshape(b, mp * page, kv, dh)
    qg = q.reshape(b, kv, group, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, kg) * dh ** -0.5
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", w, vg)
    return out.reshape(b, h, dh)


def dequantize_pages(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 page codes [P, page, KV, Dh] + per-page fp32 scales [P] ->
    fp32 values (the read-side inverse of kv_pool's quantize-on-write)."""
    return codes.float() * scale[:, None, None, None]


def paged_attention_quant(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """`paged_attention` over an int8 pool ([P, page, KV, Dh] codes with
    per-page fp32 scales [P]). The scales fold into the scores (K) and the
    softmax weights (V); the math is fp32 end to end. Returns q's dtype."""
    b, h, dh = q.shape
    p, page, kv, _ = k_pool.shape
    mp = page_table.shape[1]
    group = h // kv
    safe, valid = _gather(page_table, lengths, p, page)
    kg = k_pool[safe].reshape(b, mp * page, kv, dh)
    vg = v_pool[safe].reshape(b, mp * page, kv, dh)
    ks = k_scale[safe].repeat_interleave(page, dim=1)    # [B, mp*page]
    vs = v_scale[safe].repeat_interleave(page, dim=1)
    qg = q.reshape(b, kv, group, dh).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, kg.float())
    scores = scores * (ks[:, None, None, :] * dh ** -0.5)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w * vs[:, None, None, :],
                       vg.float())
    return out.reshape(b, h, dh).to(q.dtype)


# ------------------------------------------------------------ rg-lru
def rglru(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None = None):
    """RG-LRU linear recurrence h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0))
    * x_t over x, a [B, T, W], from h0 [B, W] (zeros when None). Walks t in
    fp32 in the order of the TPU kernel (`repro.kernels.rglru_scan`; the
    reference's oracle takes an associative scan, equal up to rounding).
    Returns (out [B, T, W] in x's dtype, h_T = out[:, -1])."""
    b, t, w = x.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, af = x.float(), a.float()
    out = torch.empty_like(x)
    for i in range(t):
        a_t = af[:, i]
        h = a_t * h + torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=0.0)) * xf[:, i]
        out[:, i] = h
    return out, out[:, -1]


def rglru_bwd(x, a, h0, dout):
    """The gradients (dx, da, dh0) of `rglru`'s output out [B, T, W] under
    the cotangent ``dout`` (a cotangent of h_T is out[:, -1]'s, so the
    caller adds it into dout[:, -1]): torch.autograd.grad through the plain
    forward, which it recomputes; dh0 is None without h0. The plain
    version of `kernels.rglru_scan.rglru_bwd`; the tests and
    `chip_smoke.py` hold the kernel against it, the main path never runs
    it. Where |a| = 1 the sqrt's derivative is infinite: da is then -inf
    or +inf, and NaN where x = 0, as the reference's autodiff gives."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, a)]
        if h0 is not None:
            leaves.append(h0.detach().requires_grad_())
        out, _ = rglru(leaves[0], leaves[1], h0=leaves[2] if h0 is not None else None)
        grads = torch.autograd.grad(out, leaves, dout)
    return grads if h0 is not None else (*grads, None)


def rglru_step(h: torch.Tensor, x_t: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    """One decode step of `rglru`: h [B, W] -> h' [B, W] in h's dtype."""
    a32 = a_t.float()
    h_new = a32 * h.float() + torch.sqrt(torch.clamp(1.0 - a32 * a32, min=0.0)) * x_t.float()
    return h_new.to(h.dtype)


# ------------------------------------------------------------ rwkv6 wkv
def rwkv6_wkv(r, k, v, w, u, s0=None, return_state: bool = False):
    """RWKV6 "Finch" WKV with data-dependent decay (exact recurrence, fp32).

    r, k, w [B, T, H, K]; v [B, T, H, V]; u [H, K]; state S [B, H, K, V]
    from s0 (zeros when None). Per step: out_t = r_t . (S + diag(u) k_t
    v_t^T), then S <- diag(w_t) S + k_t v_t^T. Returns out [B, T, H, V] in
    r's dtype, and with ``return_state`` also the final S in r's dtype."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    S = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    uf = u.float()[None, :, :, None]
    out = torch.empty((b, t, h, dv), dtype=r.dtype, device=r.device)
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]           # [B,H,K,V]
        out[:, i] = torch.einsum("bhk,bhkv->bhv", rf[:, i], S + uf * kv)
        S = wf[:, i, :, :, None] * S + kv
    if return_state:
        return out, S.to(r.dtype)
    return out


def rwkv6_wkv_bwd(r, k, v, w, u, s0, dout, ds_final=None):
    """The gradients (dr, dk, dv, dw, du, ds0) of `rwkv6_wkv`(...,
    return_state=True) under the cotangents ``dout`` of out and
    ``ds_final`` of the final state (None: zeros): torch.autograd.grad
    through the plain forward, which it recomputes; ds0 is None without
    s0. The plain version of `kernels.rwkv6_scan.rwkv6_wkv_bwd`; the tests
    and `chip_smoke.py` hold the kernel against it, the main path never
    runs it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
        if s0 is not None:
            leaves.append(s0.detach().requires_grad_())
        out, s_fin = rwkv6_wkv(*leaves[:5], s0=leaves[5] if s0 is not None else None,
                               return_state=True)
        outs, cots = [out], [dout]
        if ds_final is not None:
            outs.append(s_fin)
            cots.append(ds_final.to(s_fin.dtype))
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    # only w may reach nothing that has a cotangent, and only when T = 1
    # with neither s0 nor ds_final (S_0 = 0): its gradient is then zeros
    unused = [i for i, g in enumerate(grads) if g is None]
    if unused and (unused != [3] or r.shape[1] != 1 or s0 is not None
                   or ds_final is not None):
        raise RuntimeError(f"rwkv6_wkv_bwd: leaves {unused} of (r, k, v, w, u, s0) "
                           "reach no output")
    grads = tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves))
    return grads if s0 is not None else (*grads, None)


def rwkv6_wkv_step(S, r_t, k_t, v_t, w_t, u):
    """One decode step of `rwkv6_wkv`: S [B, H, K, V] in the cache's dtype,
    r_t, k_t, w_t [B, H, K], v_t [B, H, V] -> (S' in S's dtype, out [B, H,
    V] in r_t's dtype). The math is fp32; S' is rounded to S's dtype."""
    S32 = S.float()
    kv = k_t.float()[..., :, None] * v_t.float()[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r_t.float(), S32 + u.float()[None, :, :, None] * kv)
    S_new = w_t.float()[..., :, None] * S32 + kv
    return S_new.to(S.dtype), out.to(r_t.dtype)


# ------------------------------------------------------------ ftl lookup
def ftl_lookup(lpns: torch.Tensor, directory: torch.Tensor,
               mapping_cache: torch.Tensor, entries_per_segment: int):
    """Batched LPN -> PPN translation through the cached mapping table:
    ``slot = directory[lpn // entries]``, ``ppn = mapping_cache[slot, lpn %
    entries]``; a slot of -1 is a miss, (-1, False) (the caller schedules
    a mapping-page flash read — the paper's miss path). lpns [N],
    directory [n_seg] and mapping_cache [n_slots, entries] int32 -> (ppn
    [N] int32, hit [N] bool).

    Out-of-range LPNs are indexed as the reference's jnp gathers index
    them: ``//`` and ``%`` floor, a negative segment wraps once and is
    then clamped into the directory, and the slot is clamped into the
    cache. Nothing raises."""
    n_seg, n_slots = directory.shape[0], mapping_cache.shape[0]
    seg = torch.div(lpns, entries_per_segment, rounding_mode="floor").long()
    off = torch.remainder(lpns, entries_per_segment).long()
    seg = torch.where(seg < 0, seg + n_seg, seg).clamp(0, n_seg - 1)
    slot = directory[seg]
    hit = slot >= 0
    ppn = mapping_cache[slot.long().clamp(0, n_slots - 1), off]
    return torch.where(hit, ppn, torch.full_like(ppn, -1)), hit


# ------------------------------------------------------------ moe router
def topk_router(scores: torch.Tensor, k: int, bias: torch.Tensor | None = None):
    """Top-k expert selection: scores [T, E] fp32 (and bias [E] fp32) ->
    (weights [T, k] fp32, indices [T, k] int32).

    Selection ranks ``scores + bias`` (DeepSeek-v3's aux-free balancing),
    largest first, ties to the lowest index (as `lax.top_k` does; a
    stable descending sort keeps equal values in index order, which
    `torch.topk` does not promise). The weights renormalize the UNBIASED
    scores of the chosen experts: picked / max(sum, 1e-9)."""
    sel = scores if bias is None else scores + bias
    idx = torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :k]
    picked = torch.gather(scores, -1, idx)
    w = picked / torch.clamp(picked.sum(-1, keepdim=True), min=1e-9)
    return w, idx.to(torch.int32)


def topk_router_bwd(scores, idx, dw):
    """The gradient d scores [T, E] fp32 of `topk_router`'s weights under
    the cotangent ``dw`` [T, k], for the selection ``idx`` [T, k] the
    forward made (the bias only selects, so it has no gradient; the
    indices have none): torch.autograd.grad through the weights' plain
    formula, picked / max(sum, 1e-9), scattered into zeros at idx. The
    plain version of `kernels.moe_router.topk_router_bwd`; the tests and
    `chip_smoke.py` hold the kernel against it, the main path never runs
    it."""
    with torch.enable_grad():
        leaf = scores.detach().requires_grad_()
        picked = torch.gather(leaf, -1, idx.long())
        w = picked / torch.clamp(picked.sum(-1, keepdim=True), min=1e-9)
        return torch.autograd.grad(w, leaf, dw)[0]


# --------------------------------------------------------- shards window
EMPTY_ADDR = 0xFFFFFFFF   # SHARDS empty-table marker (uint32 all ones)
_HASH_MULT = 2654435761   # Knuth multiplicative hashing constant
_U32 = 0xFFFFFFFF


def shards_hash(addr: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 hash ``h = addr * 2654435761 (mod 2^32); h ^
    (h >> 16)`` on int64 addresses in [0, 2^32). The product would pass
    int64's range, so the low 32 bits are taken from 16-bit halves: addr
    = hi * 2^16 + lo gives addr * M = lo * M + ((hi * M) mod 2^16) * 2^16
    (mod 2^32), each term below 2^49."""
    a = addr & _U32
    lo, hi = a & 0xFFFF, a >> 16
    h = (lo * _HASH_MULT + (((hi * _HASH_MULT) & 0xFFFF) << 16)) & _U32
    return h ^ (h >> 16)


def shards_constants(sample_mod: int, sample_thresh: int,
                     bucket_width: int) -> tuple[float, float]:
    """(scale, inv_rate) of the SHARDS scan, as the reference's compiled
    code holds them in float32. Its source computes ``dist / rate /
    bucket_width``; XLA turns each division by a constant into a product
    with the constant's float32 reciprocal and folds the two into one
    factor: scale = f32(1 / f32(rate)) * f32(1 / bucket_width), rounded to
    float32. inv_rate = f32(1.0 / rate), the weight of one sampled
    reference (``1.0 / rate`` is a Python double)."""
    f = np.float32
    rate = sample_thresh / sample_mod
    scale = (f(1.0) / f(rate)) * (f(1.0) / f(bucket_width))
    return float(f(scale)), float(f(1.0 / rate))


def shards_window(addrs: torch.Tensor, last_seen: torch.Tensor,
                  clock: torch.Tensor, hist: torch.Tensor, cold: torch.Tensor,
                  total: torch.Tensor, refs: torch.Tensor, mask: torch.Tensor,
                  sample_mod: int, sample_thresh: int, bucket_width: int):
    """Fixed-size SHARDS over one window of references, every node at once
    (the reference's `shards_mrc.update`, vmapped over nodes): per node
    the table ``addrs`` int64 [N, K] (values in [0, 2^32), EMPTY_ADDR
    empty) and ``last_seen`` int32 [N, K], ``clock`` int32 [N], the
    reuse-distance histogram ``hist`` float32 [N, B], ``cold`` and
    ``total`` float32 [N]; ``refs`` int64 [N, A] (taken mod 2^32) and
    ``mask`` bool [N, A]. Returns the six updated tensors.

    Each reference in order: a masked one changes nothing; a valid one
    advances ``clock``; it is sampled iff ``hash % sample_mod <
    sample_thresh``. A sampled reference finds its row (the first match),
    its previous time ``my_last`` (the largest ``last_seen`` among
    matches, -1 on a miss), and its distance, the count of non-empty rows
    seen after ``my_last``; a hit adds ``inv_rate`` to bucket ``clip(int(
    dist * scale), 0, B - 1)``, a miss to ``cold``, either to ``total``;
    then the row (a miss evicts the first row of least ``last_seen``)
    takes the address and the clock."""
    scale, inv = shards_constants(sample_mod, sample_thresh, bucket_width)
    n, k = addrs.shape
    b_n = hist.shape[-1]
    dev = addrs.device
    refs = refs & _U32
    mask = mask.to(torch.bool)
    sampled = mask & (torch.remainder(shards_hash(refs), sample_mod)
                      < sample_thresh)
    kidx = torch.arange(k, device=dev)
    bidx = torch.arange(b_n, device=dev)
    for j in range(refs.shape[-1]):
        a, s = refs[:, j], sampled[:, j]
        match = addrs == a[:, None]
        hit = match.any(dim=-1)
        my_last = torch.where(
            hit, torch.where(match, last_seen, -1).amax(dim=-1), -1)
        dist = ((last_seen > my_last[:, None])
                & (addrs != EMPTY_ADDR)).sum(dim=-1)
        b = (dist.to(torch.float32) * scale).to(torch.int32).clamp(0, b_n - 1)
        add = (s & hit)[:, None] & (bidx == b[:, None])
        hist = torch.where(add, hist + inv, hist)
        cold = torch.where(s & ~hit, cold + inv, cold)
        total = torch.where(s, total + inv, total)
        first = torch.where(match, kidx, k).amin(dim=-1)
        least = last_seen.amin(dim=-1, keepdim=True)
        evict = torch.where(last_seen == least, kidx, k).amin(dim=-1)
        row = torch.where(hit, first, evict)
        put = s[:, None] & (kidx == row[:, None])
        addrs = torch.where(put, a[:, None], addrs)
        last_seen = torch.where(put, clock[:, None], last_seen)
        clock = clock + mask[:, j].to(torch.int32)
    return addrs, last_seen, clock, hist, cold, total
