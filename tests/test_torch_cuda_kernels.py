"""The port's hand-written CUDA kernels (paged attention, prefill flash
attention, the RG-LRU and RWKV6 scans, the MoE top-k router, the FTL
lookup, the SHARDS window scan) against their plain PyTorch versions, on
the card. Marked
``cuda``: they skip where there is no CUDA device, and import neither JAX
nor `repro`, so the card's machine runs them as they are:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Paged attention: the sweeps of tests/test_kernels.py plus the serving
engine's default layer (H4/KV2/D32) and qwen3-14b's attention width
(H40/KV8/D128), pages of 4, 8 and 16 slots, tables with holes and a row of
length 0; the engine step's pattern at qwen3-14b's width, length-0 rows
with stale page ids, pages of 1 and 32 slots, group 1 and 8, head_dim 64,
80, 256, 36 and 33 (bf16 rows off 16 bytes), full 16-page rows with holes
and pools off 16 bytes, each call repeated and equal bit for bit. Flash attention: the sweep of tests/test_kernels.py under its
three masks, head_dim 80 and 16, ragged lengths and rows with no valid
key, and the edges of the bf16 kernel's tiles (S and T off the tile
sizes, S = 1, head dims 32 to 256, windows with S < T), with the softmax
statistics it saves against `ref.attention_stats`. Flash backward:
head dims 8 to 256, GQA groups 1, 4 and 8, its three masks, S < T, T off
its key tiles and rows with no valid key, against the plain gradient and
repeated bit for bit, and refusing bad statistics; `ops.attention`'s autograd Function launching it,
serving's launches unchanged, and every other wrapper refusing grad. Scans: the
sweeps of tests/test_kernels.py, ragged lengths, initial states (h0, s0)
and the final WKV state, at the widths of
recurrentgemma-9b and rwkv6-3b; for the RG-LRU kernel also T and W across
its chunks of 32 steps and 64 channels, more blocks than SMs, a = 0 and a
= 1 exactly and views at an odd storage offset, each equal to the plain
version bit for bit; for the chunked bf16 WKV kernel also T
across its 16-row chunks, K = 128 from s0, more blocks than SMs, decays
with w = 0 and w = 1 exactly and down to e^-30, and a view off 16 bytes;
for the WKV backward also T around its groups of rows and views off 16
bytes. Router: the sweep of tests/test_kernels.py
with and without bias, DeepSeek-v2's and -v3's shapes in prefill and
decode, rows with exact ties, and the edges of its redesign (E = 31, 32,
33, 160, 256, 1024 with k = 1 and 16; T = 1, 4, 1000, 4096; rows of -0.0
and +0.0, of one value, all-negative sel, rows off 16 bytes), each
repeated bit for bit (indices exact, weights within 1e-6). FTL: the sweep
of tests/test_kernels.py, PPNs past fp32's integers, out-of-range LPNs
at entries 8 and 1000, N = 1, 3, 5 and 2^20 + 3, lpns views at offsets
1-3, a directory of 70 000 segments and entries = 1000, each repeated
bit for bit (exact). SHARDS window: tables of K = 1, 31, 48, 128 and 256
rows, windows of A = 1 to 4096 references, masks all off, all on and
padded as the engine's page tables are, repeated addresses, the EMPTY
marker as a valid reference, sample rates 1 and 1/64, 1 to 64 nodes, from
an empty and from a carried state; every output bit for bit."""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ftl_lookup as ftl
from repro_torch.kernels import moe_router as mr
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels import shards_window as sw

pytestmark = pytest.mark.cuda

# the gates of tests/test_kernels.py: fp32 3e-5, bf16 3e-2, int8 1e-5 to
# the quantized plain version
TOL = {"float32": 3e-5, "bfloat16": 3e-2, "int8": 1e-5}
SHAPES = {  # (b, h, kv, d, page, max_pages, pool pages)
    "sweep0": (2, 4, 2, 128, 8, 6, 16),
    "sweep1": (1, 8, 8, 128, 16, 4, 8),
    "sweep2": (3, 2, 1, 256, 8, 3, 12),
    "H4-KV2-D32-page4": (9, 4, 2, 32, 4, 16, 64),
    "H4-KV2-D32-page16": (40, 4, 2, 32, 16, 16, 256),
    "H40-KV8-D128-page8": (33, 40, 8, 128, 8, 16, 96),
    "H40-KV8-D128-page16": (640, 40, 8, 128, 16, 16, 384),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(form, shape, seed, dev, pattern="random", offset=0):
    """Random tables with holes and the last row of length 0; then per
    ``pattern``: "main", the engine step's (rows 16k .. 16k + 8 of length
    0 with all-hole tables, the rest one page, one row of exactly ``page``
    tokens and one of page + 1); "stale", every other row of length 0 with
    stale page ids (>= 0); "full", every row max_pages pages with 3 holes.
    ``offset`` puts the pools ``offset`` elements into their storage."""
    b, h, kv, d, page, mp, n_pages = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, d), generator=g)
    planes = [torch.randn((n_pages, page, kv, d), generator=g) for _ in range(2)]
    table = torch.full((b, mp), -1, dtype=torch.int32)
    lengths = torch.zeros(b, dtype=torch.int32)
    for i in range(b):
        n = int(torch.randint(1, mp + 1, (1,), generator=g))
        table[i, :n] = torch.randperm(n_pages, generator=g)[:n].to(torch.int32)
        lengths[i] = int(torch.randint(1, n * page + 1, (1,), generator=g))
        if n > 1 and i % 2 == 0:
            table[i, int(torch.randint(0, n - 1, (1,), generator=g))] = -1
    if pattern == "main":
        table.fill_(-1)
        lengths = torch.randint(1, page + 1, (b,), generator=g, dtype=torch.int32)
        table[:, 0] = torch.randint(0, n_pages, (b,), generator=g, dtype=torch.int32)
        idle = torch.arange(b) % 16 < 9
        lengths[idle] = 0
        table[idle] = -1
        lengths[1], lengths[2] = page, page + 1
        table[1, 0], table[2, :2] = 1, torch.tensor([2, 3], dtype=torch.int32)
    elif pattern == "stale":
        lengths[::2] = 0
        table[::2] = torch.randint(0, n_pages, (len(table[::2]), mp), generator=g,
                                   dtype=torch.int32)
    elif pattern == "full":
        for i in range(b):
            table[i] = torch.randperm(n_pages, generator=g)[:mp].to(torch.int32)
            table[i, torch.randperm(mp, generator=g)[:3]] = -1
        lengths = (mp - 1) * page + torch.randint(1, page + 1, (b,), generator=g,
                                                  dtype=torch.int32)
    lengths[-1] = 0
    kw = {}
    if form == "int8":
        scales = [x.abs().amax(dim=(1, 2, 3)) / 127.0 for x in planes]
        planes = [torch.clamp(torch.round(x / s[:, None, None, None]), -127,
                              127).to(torch.int8) for x, s in zip(planes, scales)]
        kw = {"k_scale": scales[0].to(dev), "v_scale": scales[1].to(dev)}
    else:
        dt = getattr(torch, form)
        q, planes = q.to(dt), [x.to(dt) for x in planes]
    if offset:
        views = []
        for x in planes:
            buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
            buf[offset:] = x.flatten().to(dev)
            views.append(buf[offset:].view(x.shape))
        planes = views
    args = [t.to(dev) for t in (q, *planes, table, lengths)]
    return args, kw


def _plain(args, kw):
    if kw:
        q, k, v, table, lengths = args
        return ref.paged_attention_quant(q, k, v, kw["k_scale"], kw["v_scale"],
                                         table, lengths)
    return ref.paged_attention(*args)


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain(dev, name, form):
    args, kw = _inputs(form, SHAPES[name], seed=len(name), dev=dev)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    if kw:
        want = ref.paged_attention_quant(args[0], args[1], args[2],
                                         kw["k_scale"], kw["v_scale"],
                                         args[3], args[4])
    else:
        want = ref.paged_attention(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[form], rtol=TOL[form])


# the engine step's pattern and the edges of the kernel's design (its
# warps-per-unit split, 128-dim output blocks, copy widths from 16 bytes
# down): (b, h, kv, d, page, max_pages, pool pages, pattern of `_inputs`)
PATTERNS = {
    "main-path-H40-KV8-D128": (640, 40, 8, 128, 16, 16, 384, "main"),
    "stale-ids": (64, 40, 8, 128, 16, 16, 384, "stale"),
    "page1": (24, 8, 4, 64, 1, 40, 512, "random"),
    "page32": (12, 8, 2, 128, 32, 8, 64, "random"),
    "group1-D80": (16, 8, 8, 80, 16, 8, 96, "random"),
    "group8-D256": (16, 16, 2, 256, 16, 8, 96, "random"),
    "D64": (20, 8, 2, 64, 16, 8, 96, "random"),
    "D36": (20, 8, 2, 36, 16, 8, 96, "random"),    # bf16 rows of 72 bytes
    "D33": (20, 8, 2, 33, 16, 8, 96, "random"),    # bf16 rows of 66 bytes
    "full-16-pages": (64, 40, 8, 128, 16, 16, 384, "full"),
}


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", list(PATTERNS))
def test_kernel_matches_plain_on_patterns(dev, name, form):
    """The plain version's result within the gate, and a repeated call
    equal bit for bit."""
    *shape, pattern = PATTERNS[name]
    args, kw = _inputs(form, tuple(shape), seed=len(name), dev=dev, pattern=pattern)
    got = pa.paged_attention(*args, **kw)
    again = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = _plain(args, kw)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[form], rtol=TOL[form])


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
def test_kernel_takes_pools_off_16_bytes(dev, form):
    """Pools one element into their storage: the narrowest copies (4, 2
    and 1 bytes for fp32, bf16 and int8)."""
    args, kw = _inputs(form, (9, 8, 2, 64, 8, 6, 24), seed=11, dev=dev, offset=1)
    assert args[1].data_ptr() % 16 != 0
    got = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), _plain(args, kw).float(),
                               atol=TOL[form], rtol=TOL[form])


def test_dispatcher_launches_for_cuda_tensors(dev):
    args, _ = _inputs("float32", SHAPES["sweep0"], seed=1, dev=dev)
    before = pa.paged_attention.launches
    ops.paged_attention(*args)
    assert pa.paged_attention.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    args, _ = _inputs("float32", SHAPES["sweep0"], seed=2, dev=dev)
    q, k, v, table, lengths = args
    with pytest.raises(ValueError):
        pa.paged_attention(q, k.half(), v, table, lengths)       # dtype
    with pytest.raises(ValueError):
        pa.paged_attention(q, k, v, table.long(), lengths)       # index type
    with pytest.raises(ValueError):
        pa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           k, v, table, lengths)                 # layout
    with pytest.raises(ValueError):
        pa.paged_attention(q, k, v, table, lengths.cpu())        # device
    with pytest.raises(ValueError, match="limits"):               # group * D
        pa.paged_attention(torch.zeros((1, 64, 128), device=dev),
                           k[:, :, :1].contiguous(), v[:, :, :1].contiguous(),
                           table[:1], lengths[:1])


# ---------------------------------------------------------------- flash
# (b, s, t, h, kv, d, causal, window): the sweep of tests/test_kernels.py
# under its three masks, head_dim 80 (h2o-danube) and 16 (the smoke
# configs), a ragged non-causal length, queries offset against a longer
# key sequence, and rows with no valid key (causal, S > T)
FLASH_SWEEP = [(2, 256, 4, 2, 128), (1, 384, 6, 6, 128), (2, 128, 8, 1, 128),
               (1, 512, 2, 2, 256)]
FLASH_SHAPES = {
    f"sweep{i}-{'causal' if c else 'full'}-w{w}": (b, s, s, h, kv, d, c, w)
    for i, (b, s, h, kv, d) in enumerate(FLASH_SWEEP)
    for c, w in ((True, 0), (True, 128), (False, 0))
}
FLASH_SHAPES.update({
    "d80-causal": (2, 256, 256, 32, 8, 80, True, 0),
    "d80-window": (1, 300, 300, 32, 8, 80, True, 96),
    "d16-causal": (3, 70, 70, 4, 2, 16, True, 0),
    "ragged-200-full": (1, 200, 200, 4, 2, 128, False, 0),
    "s64-t256-causal": (2, 64, 256, 8, 2, 128, True, 0),
    "s256-t64-no-valid-key-rows": (1, 256, 64, 4, 2, 128, True, 0),
    "s256-t64-window": (1, 256, 64, 4, 2, 80, True, 32),
    # the edges of the wgmma kernel's tiles (128 query rows, 128 or 80
    # keys, boxes of 16, 32 or 64 columns): ragged S and T, S = 1, head
    # dims 32, 64 and 96, recurrentgemma-9b's layout cut down, head_dim 80
    # with S < T under a window
    "s129-t191-causal": (1, 129, 191, 4, 2, 128, True, 0),
    "s191-t129-full": (2, 191, 129, 4, 2, 64, False, 0),
    "s1-t77-causal": (1, 1, 77, 4, 2, 96, True, 0),
    "s1-t300-window": (2, 1, 300, 8, 1, 256, True, 128),
    "d32-s300-window": (1, 300, 300, 4, 2, 32, True, 64),
    "d64-causal": (2, 256, 256, 8, 8, 64, True, 0),
    "d96-ragged-full": (1, 200, 200, 6, 3, 96, False, 0),
    "recurrentgemma-cut": (1, 300, 300, 16, 1, 256, True, 128),
    "d80-s200-t300-window": (1, 200, 300, 32, 8, 80, True, 96),
    # more work items than the H100's 132 SMs, so each persistent block
    # walks several (the barrier phases carry over between them)
    "many-items-causal": (2, 1100, 1100, 16, 4, 64, True, 0),
    "many-items-d256-window": (1, 650, 650, 48, 2, 256, True, 200),
})


def _flash_inputs(shape, dtype, seed, dev):
    b, s, t, h, kv, d, _, _ = shape
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(sh, generator=g).to(getattr(torch, dtype)).to(dev)
            for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FLASH_SHAPES))
def test_flash_kernel_matches_plain(dev, name, dtype):
    shape = FLASH_SHAPES[name]
    causal, window = shape[6], shape[7]
    q, k, v = _flash_inputs(shape, dtype, seed=len(name), dev=dev)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ref.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_dispatcher_launches_for_cuda_tensors(dev):
    q, k, v = _flash_inputs(FLASH_SHAPES["d16-causal"], "float32", 1, dev)
    before = fa.flash_attention.launches
    ops.attention(q, k, v)
    assert fa.flash_attention.launches == before + 1


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _flash_inputs(FLASH_SHAPES["d16-causal"], "float32", 2, dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.bfloat16(), v)                      # dtype
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half())            # dtype
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)                                    # layout
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)                           # device
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, v, causal=False, window=8)         # mask
    with pytest.raises(ValueError, match="limits"):                 # head_dim
        fa.flash_attention(torch.zeros((1, 8, 2, 24), device=dev),
                           torch.zeros((1, 8, 1, 24), device=dev),
                           torch.zeros((1, 8, 1, 24), device=dev))
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted[1:] = qb.flatten()
    with pytest.raises(ValueError, match="16 bytes"):               # TMA alignment
        fa.flash_attention(shifted[1:].view(qb.shape), kb, vb)


# ------------------------------------------------------- flash backward
# (b, s, t, h, kv, d, causal, window): head dims 64, 80, 128, 256 (and 8,
# 16, 40: any multiple of 8), GQA groups 1, 4 and 8, causal, non-causal
# and causal with a window, S = T and S < T, T off the kernel's key tiles
# (64 keys, 32 above D = 128), rows with no valid key (S > T)
BWD_SHAPES = {
    "d64-g1-causal": (2, 256, 256, 4, 4, 64, True, 0),
    "d64-g4-full-ragged": (1, 200, 200, 8, 2, 64, False, 0),
    "d80-g4-window": (1, 300, 300, 32, 8, 80, True, 96),
    "d80-g8-causal-s<t": (2, 100, 300, 8, 1, 80, True, 0),
    "d128-g8-window-s<t": (1, 130, 333, 16, 2, 128, True, 100),
    "d128-g1-full": (2, 128, 128, 4, 4, 128, False, 0),
    "d256-g4-causal-ragged": (1, 190, 190, 8, 2, 256, True, 0),
    "d256-g8-window-s<t": (1, 200, 260, 8, 1, 256, True, 64),
    "d256-g1-full-s<t": (1, 70, 150, 2, 2, 256, False, 0),
    "d40-g2-causal": (1, 97, 97, 4, 2, 40, True, 0),
    "d16-no-key-rows": (1, 80, 50, 4, 2, 16, True, 0),
    "d8-g2-causal": (1, 33, 33, 2, 1, 8, True, 0),
}
def _bwd_inputs(shape, dtype, seed, dev):
    """q, k, v, the plain forward's output and statistics, a cotangent."""
    b, s, t, h, kv, d, causal, window = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = [torch.randn(sh, generator=g).to(getattr(torch, dtype)).to(dev)
                     for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]
    return (q, k, v, ref.attention(q, k, v, causal=causal, window=window).contiguous(),
            ref.attention_stats(q, k, causal=causal, window=window), dout)


def _bwd_close(got, q, k, v, o, dout, causal, window, dtype):
    """chip_smoke's gates (`bwd_check`): each gradient per element within
    c1 * |want| + c2 * rms(want) of the plain gradient in fp32 of the
    inputs widened (BWD_TOL) and of the backward's formulas given the same
    o (BWD_O_TOL)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    for name, g_, x in zip(("dq", "dk", "dv"), got, (q, k, v)):
        assert g_.dtype == x.dtype and g_.shape == x.shape, name
    gates = chip_smoke.bwd_check(got, q, k, v, o, dout, causal, window,
                                 "fp32" if dtype == "float32" else "bf16")
    assert chip_smoke.bwd_ok(gates), gates


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_flash_bwd_kernel_matches_plain(dev, name, dtype):
    """The backward kernel's (dq, dk, dv) against the plain gradient, and a
    repeated call equal bit for bit (no atomics)."""
    shape = BWD_SHAPES[name]
    causal, window = shape[6], shape[7]
    q, k, v, o, stats, dout = _bwd_inputs(shape, dtype, seed=len(name), dev=dev)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
    again = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    _bwd_close(got, q, k, v, o, dout, causal, window, dtype)


@pytest.mark.parametrize("name", ["d64-g1-causal", "d80-g4-window", "d16-no-key-rows",
                                  "d256-g8-window-s<t", "d256-g1-full-s<t"])
def test_flash_bwd_split_and_whole_walks_agree(dev, name, monkeypatch):
    """bf16 dk / dv walks cut into runs (`bwd_split`, the default at these
    small shapes) and whole (one run, as at h2o-danube's training shape):
    dq equal bit for bit, dk and dv both within the gates, each repeated
    bit for bit."""
    shape = BWD_SHAPES[name]
    causal, window = shape[6], shape[7]
    q, k, v, o, stats, dout = _bwd_inputs(shape, "bfloat16", seed=len(name) + 2, dev=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fa.bwd_split(q.dtype, k.shape[0], k.shape[1], k.shape[2], sms) > 1
    cut = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
    monkeypatch.setattr(fa, "_SPLIT_BLOCKS_PER_SM", 0)
    assert fa.bwd_split(q.dtype, k.shape[0], k.shape[1], k.shape[2], sms) == 1
    whole = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
    again = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(cut[0], whole[0])
    for a, b_ in zip(whole, again):
        assert torch.equal(a, b_)
    for got in (cut, whole):
        _bwd_close(got, q, k, v, o, dout, causal, window, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_function_backward_launches_the_kernel(dev, dtype):
    """`ops.attention` on inputs that need a gradient: one forward and one
    backward launch, gradients equal to the plain version's."""
    shape = BWD_SHAPES["d80-g4-window"]
    q, k, v, _, _, dout = _bwd_inputs(shape, dtype, seed=3, dev=dev)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = ops.attention(*leaves, causal=True, window=96)
    # a cotangent that is a view, not contiguous: the backward copies it
    out.backward(dout.transpose(1, 2).contiguous().transpose(1, 2))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == fwd + 1
    assert fa.flash_attention_bwd.launches == bwd + 1
    _bwd_close([x.grad for x in leaves], q, k, v, out.detach(), dout, True, 96, dtype)


def test_attention_without_grad_launches_the_forward_only(dev):
    """What serving launches is unchanged: nothing needs a gradient, one
    forward launch and no backward, under grad mode or not."""
    q, k, v, _, _, _ = _bwd_inputs(BWD_SHAPES["d64-g1-causal"], "bfloat16", 4, dev)
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    ops.attention(q, k, v)
    with torch.no_grad():
        ops.attention(q.requires_grad_(), k, v)
    assert fa.flash_attention.launches == fwd + 2
    assert fa.flash_attention_bwd.launches == bwd


def test_every_other_wrapper_refuses_grad(dev):
    """No CUDA wrapper hands back a result cut from the autograd graph: a
    forward wrapper whose gradient is an autograd Function (flash
    attention, the scans, the router: `ops` calls the Function) and every
    backward wrapper (no double backward) raise under grad mode when a
    floating input needs a gradient, as do the wrappers without a backward
    kernel (paged attention, the SHARDS window); all run as before under
    no_grad."""
    x = torch.rand((1, 64, 64), device=dev, requires_grad=True)
    a = torch.rand((1, 64, 64), device=dev)
    r = torch.rand((1, 16, 2, 16), device=dev, requires_grad=True)
    w = torch.rand((1, 16, 2, 16), device=dev)
    u = torch.rand((2, 16), device=dev)
    scores = torch.rand((8, 16), device=dev, requires_grad=True)
    idx = torch.zeros((8, 2), dtype=torch.int32, device=dev)
    idx[:, 1] = 1
    q, k, v, o, st, dout = _bwd_inputs(BWD_SHAPES["d64-g1-causal"], "float32", 5, dev)
    calls = {
        "rglru": lambda: rg.rglru(x, a),
        "rglru_bwd": lambda: rg.rglru_bwd(x, a, None, a),
        "rwkv6_wkv": lambda: wkv.rwkv6_wkv(r, w, w, w, u),
        "rwkv6_wkv_bwd": lambda: wkv.rwkv6_wkv_bwd(r, w, w, w, u, None, w),
        "topk_router": lambda: mr.topk_router(scores, 2),
        "topk_router_bwd": lambda: mr.topk_router_bwd(scores, idx,
                                                       scores[:, :2].detach().contiguous()),
        "flash_attention": lambda: fa.flash_attention(q.requires_grad_(), k, v),
        "flash_attention_bwd": lambda: fa.flash_attention_bwd(q.requires_grad_(), k, v,
                                                              o, st, dout),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="later slice: no backward kernel"):
            call()
        with torch.no_grad():
            call()
    pargs, kw = _inputs("float32", SHAPES["sweep0"], 6, dev)
    pargs[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="paged_attention"):
        pa.paged_attention(*pargs, **kw)
    sargs, consts = _sw_inputs(48, "a1", 1, dev)
    sargs = list(sargs)
    sargs[3] = sargs[3].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="shards_window"):
        sw.shards_window(*sargs, *consts)


def test_flash_bwd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, o, st, dout = _bwd_inputs(BWD_SHAPES["d16-no-key-rows"], "float32", 7, dev)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o.bfloat16(), st, dout)    # dtype
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, st, dout[:, :-1])       # shape
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, st, dout.transpose(1, 2).contiguous()
                               .transpose(1, 2))                    # layout
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, st, dout, causal=False, window=8)
    qd, kd, vd, od, dd = (torch.zeros((1, 4, 2, 12), device=dev) for _ in range(5))
    sd = torch.ones((2, 1, 2, 4), device=dev)
    with pytest.raises(ValueError, match="limits"):                  # D not a multiple of 8
        fa.flash_attention_bwd(qd, kd, vd, od, sd, dd)
    # the statistics: required, float32 [2, B, H, S], contiguous, on q's device
    for bad in (None, st.double(), st[:, :, :, :-1], st.cpu(), st[:1],
                st.transpose(2, 3).contiguous().transpose(2, 3)):
        with pytest.raises(ValueError, match="stats"):
            fa.flash_attention_bwd(q, k, v, o, bad, dout)
    qb, kb, vb, ob, sb, db = _bwd_inputs(BWD_SHAPES["d64-g1-causal"], "bfloat16", 8, dev)
    shifted = torch.empty(db.numel() + 1, dtype=db.dtype, device=dev)
    shifted[1:] = db.flatten()
    with pytest.raises(ValueError, match="16 bytes"):               # TMA alignment
        fa.flash_attention_bwd(qb, kb, vb, ob, sb, shifted[1:].view(db.shape))
    with pytest.raises(ValueError, match="stats"):                  # the forward's too
        fa.flash_attention(qb, kb, vb, stats=sb[:, :, :1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["d80-window", "d16-causal", "s256-t64-no-valid-key-rows",
                                  "s256-t64-window", "s1-t300-window", "ragged-200-full",
                                  "many-items-d256-window"])
def test_flash_forward_stats_match_plain(dev, name, dtype):
    """The forward's softmax statistics (m, l per row, natural units)
    against `ref.attention_stats` under chip_smoke's STATS_TOL, rows with
    no valid key at NEG_INF exactly; the output equal bit for bit to a
    call that stores none."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    shape = FLASH_SHAPES[name]
    b, s, _, h = shape[:4]
    causal, window = shape[6], shape[7]
    q, k, v = _flash_inputs(shape, dtype, seed=len(name) + 1, dev=dev)
    stats = torch.full((2, b, h, s), float("nan"), device=dev)
    got = fa.flash_attention(q, k, v, causal=causal, window=window, stats=stats)
    plain = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    gate = chip_smoke.stats_check(stats, q, k, causal, window)
    assert gate["ok"], gate
    assert gate["no_key_rows"] == (max(0, s - shape[2]) * b * h if causal else 0)


# ---------------------------------------------------------------- scans
# the RG-LRU kernel repeats the plain version's IEEE operations in fp32;
# the RWKV6 kernel sums K terms in another order than the plain einsum;
# bf16 outputs may differ by one rounding of the fp32 result
SCAN_TOL = {"rglru": {"float32": 1e-5, "bfloat16": 3e-2},
            "rwkv6": {"float32": 1e-4, "bfloat16": 3e-2}}
# (b, t, w, h0[, a[, offset]]): the sweep of tests/test_kernels.py, a
# ragged T from an initial state, T = 1 (shorter than one chunk), a W that
# is no multiple of the block, and recurrentgemma-9b's width; then the
# edges of the kernel's tiles (chunks of 32 steps, 64 channels): T = 31, 32
# and 33, W = 40 and 130 (bf16 rows of 80 and 260 bytes) from h0, more
# blocks than SMs, B * W under one tile, an `a` with a quarter exactly 0
# and a quarter exactly 1, and x and a as contiguous views an odd number of
# elements into their storage (bf16 copied in 2-byte, fp32 in 4-byte
# pieces)
RGLRU_SHAPES = {
    "sweep0": (2, 256, 64, False), "sweep1": (1, 512, 128, False),
    "sweep2": (3, 128, 256, False), "ragged-200-h0": (2, 200, 96, True),
    "t1-h0": (3, 1, 40, True), "w130-t37-h0": (1, 37, 130, True),
    "recurrentgemma-width": (4, 256, 4096, False),
    "t31": (2, 31, 64, False), "t32-h0": (1, 32, 128, True),
    "t33": (3, 33, 64, False), "w40-h0": (2, 75, 40, True),
    "w130-h0": (3, 70, 130, True), "blocks-over-sms-h0": (1, 66, 9000, True),
    "under-one-tile": (1, 45, 24, False),
    "a-zero-one-h0": (2, 100, 96, True, "zero-one"),
    "a-zero-one-w130": (1, 65, 130, False, "zero-one"),
    "offset1-w130-h0": (2, 70, 130, True, "sigmoid", 1),
    "offset3-t33": (1, 33, 64, False, "sigmoid", 3),
}
# (b, t, h, k, s0[, decay]): the sweep of tests/test_kernels.py, the
# smoke width (16) and 32 from an initial state over a ragged T, rwkv6-3b's
# heads; then the bf16 kernel's chunks of 16 rows (T = 1, 63, 64, 65, 129),
# K = 128 from s0, more blocks than SMs, and the decays of `_decay`
RWKV6_SHAPES = {
    "sweep0": (1, 256, 2, 64, False), "sweep1": (2, 128, 4, 128, False),
    "k16-s0": (3, 70, 4, 16, True), "k32-ragged-200-s0": (2, 200, 3, 32, True),
    "rwkv6-3b-heads-s0": (1, 256, 40, 64, True),
    "t1-s0": (2, 1, 3, 64, True), "t63": (1, 63, 2, 64, False),
    "t64-s0": (1, 64, 2, 32, True), "t65-s0": (2, 65, 2, 64, True),
    "t129-k16-s0": (1, 129, 4, 16, True), "k128-t97-s0": (2, 97, 2, 128, True),
    "grid-2x80-heads": (2, 512, 80, 64, False),
    "w-zero-one-s0": (2, 200, 3, 64, True, "zero-one"),
    "w-zero-one-k16": (1, 65, 2, 16, False, "zero-one"),
    "w-near0-k128-s0": (1, 130, 2, 128, True, "near0"),
    "w-near0-k32": (2, 77, 3, 32, False, "near0"),
    "w-main-s0": (2, 300, 4, 64, True, "main"),
}


def _decay(shape, kind, g):
    """w [shape]: the sweeps' sigmoid(N + 2); "main", exp(-exp(N / 10)) near
    e^-1 as rwkv6-3b's zero-initialised w_base gives; "near0", exp(-U(0,
    30)), down to e^-30; "zero-one", sigmoid(N + 2) with a quarter exactly
    0 and a quarter exactly 1."""
    z = torch.randn(shape, generator=g)
    if kind == "main":
        return torch.exp(-torch.exp(0.1 * z))
    if kind == "near0":
        return torch.exp(-30.0 * torch.rand(shape, generator=g))
    w = torch.sigmoid(z + 2)
    if kind == "zero-one":
        pick = torch.rand(shape, generator=g)
        w = torch.where(pick < 0.25, 0.0, torch.where(pick > 0.75, 1.0, w))
    return w


def _rglru_inputs(shape, dtype, seed, dev):
    b, t, w, h0 = shape[:4]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, w), generator=g)
    a = torch.sigmoid(torch.randn((b, t, w), generator=g))
    kind = shape[4] if len(shape) > 4 else "sigmoid"
    offset = shape[5] if len(shape) > 5 else 0
    if kind == "zero-one":  # a quarter exactly 0, a quarter exactly 1
        pick = torch.rand((b, t, w), generator=g)
        a = torch.where(pick < 0.25, 0.0, torch.where(pick > 0.75, 1.0, a))
    h = torch.randn((b, w), generator=g) if h0 else None
    dt = getattr(torch, dtype)
    x, a = x.to(dt).to(dev), a.to(dt).to(dev)
    if offset:  # contiguous views `offset` elements into their storage
        x, a = (torch.cat([v.new_zeros(offset), v.flatten()])[offset:].view(v.shape)
                for v in (x, a))
    return x, a, None if h is None else h.to(dev)


def _rwkv6_inputs(shape, dtype, seed, dev):
    b, t, h, k, s0 = shape[:5]
    g = torch.Generator().manual_seed(seed)
    r, kk, v = (torch.randn((b, t, h, k), generator=g) * 0.5 for _ in range(3))
    w = _decay((b, t, h, k), shape[5] if len(shape) > 5 else "sigmoid", g)
    u = torch.randn((h, k), generator=g) * 0.1
    s = torch.randn((b, h, k, k), generator=g) * 0.5 if s0 else None
    dt = getattr(torch, dtype)
    return ([x.to(dt).to(dev) for x in (r, kk, v, w)], u.to(dev),
            None if s is None else s.to(dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RGLRU_SHAPES))
def test_rglru_kernel_matches_plain(dev, name, dtype):
    x, a, h0 = _rglru_inputs(RGLRU_SHAPES[name], dtype, seed=len(name), dev=dev)
    before = rg.rglru.launches
    out, h_t = rg.rglru(x, a, h0=h0)
    torch.cuda.synchronize()
    assert rg.rglru.launches == before + 1
    want, want_h = ref.rglru(x, a, h0=h0)
    assert out.dtype == x.dtype and out.shape == x.shape
    tol = SCAN_TOL["rglru"][dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h_t.float(), want_h.float(), atol=tol, rtol=tol)
    # the kernel does the plain version's IEEE operations in its order
    assert torch.equal(out, want) and torch.equal(h_t, want_h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RWKV6_SHAPES))
def test_rwkv6_kernel_matches_plain(dev, name, dtype):
    (r, k, v, w), u, s0 = _rwkv6_inputs(RWKV6_SHAPES[name], dtype, seed=len(name),
                                        dev=dev)
    before = wkv.rwkv6_wkv.launches
    out, S = wkv.rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)
    torch.cuda.synchronize()
    assert wkv.rwkv6_wkv.launches == before + 1
    want, want_S = ref.rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)
    assert out.dtype == r.dtype and S.dtype == r.dtype and S.shape == want_S.shape
    tol = SCAN_TOL["rwkv6"][dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(S.float(), want_S.float(), atol=tol, rtol=tol)
    # without the final state: the same outputs
    assert torch.equal(wkv.rwkv6_wkv(r, k, v, w, u, s0=s0), out)


def test_rwkv6_bf16_view_off_16_bytes_takes_the_serial_kernel(dev):
    """The chunked kernel copies 16-byte pieces; a bf16 view that starts 2
    bytes in runs the serial kernel, with the same launch count and gate."""
    (r, k, v, w), u, s0 = _rwkv6_inputs((1, 70, 2, 32, True), "bfloat16", 3, dev)
    shifted = torch.empty(r.numel() + 1, dtype=r.dtype, device=dev)
    shifted[1:] = r.flatten()
    r_view = shifted[1:].view(r.shape)
    assert r_view.data_ptr() % 16 != 0 and r_view.is_contiguous()
    before = wkv.rwkv6_wkv.launches
    out, S = wkv.rwkv6_wkv(r_view, k, v, w, u, s0=s0, return_state=True)
    torch.cuda.synchronize()
    assert wkv.rwkv6_wkv.launches == before + 1
    want, want_S = ref.rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)
    tol = SCAN_TOL["rwkv6"]["bfloat16"]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(S.float(), want_S.float(), atol=tol, rtol=tol)


def test_scan_dispatchers_launch_for_cuda_tensors(dev):
    x, a, _ = _rglru_inputs(RGLRU_SHAPES["sweep0"], "float32", 1, dev)
    before = rg.rglru.launches
    ops.rglru(x, a)
    assert rg.rglru.launches == before + 1
    (r, k, v, w), u, _ = _rwkv6_inputs(RWKV6_SHAPES["sweep0"], "float32", 1, dev)
    before = wkv.rwkv6_wkv.launches
    ops.rwkv6_wkv(r, k, v, w, u, return_state=True)
    assert wkv.rwkv6_wkv.launches == before + 1


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, a, _ = _rglru_inputs(RGLRU_SHAPES["sweep0"], "float32", 2, dev)
    with pytest.raises(ValueError):
        rg.rglru(x, a.bfloat16())                                   # dtype
    with pytest.raises(ValueError):
        rg.rglru(x.half(), a.half())                                # dtype
    with pytest.raises(ValueError):
        rg.rglru(x.transpose(0, 1).contiguous().transpose(0, 1), a)  # layout
    with pytest.raises(ValueError):
        rg.rglru(x, a.cpu())                                        # device
    with pytest.raises(ValueError):
        rg.rglru(x, a, h0=torch.zeros((1, 64), device=dev))         # h0 shape
    (r, k, v, w), u, _ = _rwkv6_inputs(RWKV6_SHAPES["sweep0"], "float32", 2, dev)
    with pytest.raises(ValueError):
        wkv.rwkv6_wkv(r, k.bfloat16(), v, w, u)                     # dtype
    with pytest.raises(ValueError):
        wkv.rwkv6_wkv(r, k, v, w, u[:1])                            # u shape
    with pytest.raises(ValueError):
        wkv.rwkv6_wkv(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError, match="limits"):                 # K = 48
        z = torch.zeros((1, 4, 2, 48), device=dev)
        wkv.rwkv6_wkv(z, z, z, z, torch.zeros((2, 48), device=dev))
    with pytest.raises(ValueError, match="limits"):                 # K != V
        wkv.rwkv6_wkv(r, k, v[..., :32].contiguous(), w, u)


# ---------------------------------------------------------------- router
# (t, e, k): the sweep of tests/test_kernels.py, DeepSeek-v2's (160, 6)
# and -v3's (256, 8) experts at a decode step's 4 tokens, a prefill's 4096
# and a ragged 1000, one scores row of 1024 (the kernel's limit) and E = 8
# (the smoke configs)
ROUTER_SHAPES = {
    "sweep0": (256, 128, 6), "sweep1": (512, 256, 8), "sweep2": (128, 160, 2),
    "v2-decode": (4, 160, 6), "v2-prefill": (4096, 160, 6), "v2-ragged": (1000, 160, 6),
    "v3-decode": (4, 256, 8), "v3-prefill": (4096, 256, 8), "v3-ragged": (1000, 256, 8),
    "e1024-k16": (37, 1024, 16), "smoke-e8": (24, 8, 2),
}


def _router_inputs(shape, bias, seed, dev, ties=False):
    t, e, _ = shape
    g = torch.Generator().manual_seed(seed)
    if ties:    # four values per row, so every row has exact ties
        scores = torch.randint(0, 4, (t, e), generator=g).float() / 8
    else:
        scores = torch.softmax(torch.randn((t, e), generator=g), -1)
    b = torch.randn((e,), generator=g) * 0.1 if bias else None
    return scores.to(dev), None if b is None else b.to(dev)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("name", list(ROUTER_SHAPES))
def test_router_kernel_matches_plain(dev, name, bias, ties):
    shape = ROUTER_SHAPES[name]
    scores, b = _router_inputs(shape, bias, seed=len(name), dev=dev, ties=ties)
    before = mr.topk_router.launches
    w, idx = mr.topk_router(scores, shape[2], bias=b)
    torch.cuda.synchronize()
    assert mr.topk_router.launches == before + 1
    want_w, want_idx = ref.topk_router(scores, shape[2], bias=b)
    assert w.dtype == torch.float32 and idx.dtype == torch.int32
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(w, want_w, atol=1e-6, rtol=0)


# the edges of the router kernel: (t, e, k, pattern) — E around a lane's
# slot count, DeepSeek's two counts and the limit, k = 1 and 16, T = 1, 4,
# 1000 and 4096; rows of -0.0 and +0.0 ("zeros"), of one value ("equal"),
# a bias that makes every sel negative ("negbias"), rows of E % 4 == 0 off
# 16 bytes ("offset")
ROUTER_EDGES = {f"e{e}-k{k}": (1000, e, k, "random") for e in (31, 32, 33, 160, 256, 1024)
                for k in (1, 16)}
ROUTER_EDGES.update({f"t{t}-e{e}": (t, e, k, "random") for t in (1, 4, 1000, 4096)
                     for e, k in ((160, 6), (256, 8))})
ROUTER_EDGES.update({f"{pattern}-e{e}-k{k}": (t, e, k, pattern)
                     for t, e, k in ((64, 160, 6), (64, 256, 8), (64, 33, 16), (37, 1024, 16))
                     for pattern in ("zeros", "equal", "negbias", "offset")})


def _router_edge_inputs(t, e, pattern, bias, seed, dev):
    g = torch.Generator().manual_seed(seed)
    if pattern == "zeros":     # -0.0 and +0.0 tie; a small positive every 7th
        scores = torch.where(torch.rand((t, e), generator=g) < 0.5,
                             torch.tensor(-0.0), torch.tensor(0.0))
        scores[:, ::7] = torch.rand((t, (e + 6) // 7), generator=g) * 0.01
    elif pattern == "equal":
        scores = torch.full((t, e), 1.0 / e)
    elif pattern == "negbias":
        scores = torch.sigmoid(torch.randn((t, e), generator=g))
    else:
        scores = torch.softmax(torch.randn((t, e), generator=g), -1)
    b = torch.randn((e,), generator=g) * 0.1 - (2.0 if pattern == "negbias" else 0.0)
    scores = scores.to(dev)
    if pattern == "offset":    # a view one element into its storage
        store = torch.empty(t * e + 1, device=dev)
        store[1:] = scores.view(-1)
        scores = store[1:].view(t, e)
    return scores, b.to(dev) if bias else None


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("name", list(ROUTER_EDGES))
def test_router_kernel_edges_match_plain_and_repeat(dev, name, bias):
    t, e, k, pattern = ROUTER_EDGES[name]
    scores, b = _router_edge_inputs(t, e, pattern, bias, len(name), dev)
    before = mr.topk_router.launches
    w, idx = mr.topk_router(scores, k, bias=b)
    w2, idx2 = mr.topk_router(scores, k, bias=b)
    torch.cuda.synchronize()
    assert mr.topk_router.launches == before + 2
    want_w, want_idx = ref.topk_router(scores, k, bias=b)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(w, want_w, atol=1e-6, rtol=0)
    assert torch.equal(idx2, idx) and torch.equal(w2.view(torch.int32), w.view(torch.int32))
    if pattern == "equal" and b is None:   # one value: the lowest indices, in order
        assert torch.equal(idx, torch.arange(k, dtype=torch.int32, device=dev).expand(t, k))


def test_router_dispatcher_launches_for_cuda_tensors(dev):
    scores, b = _router_inputs(ROUTER_SHAPES["v3-decode"], True, 1, dev)
    before = mr.topk_router.launches
    ops.topk_router(scores, 8, bias=b)
    assert mr.topk_router.launches == before + 1


def test_router_wrapper_refuses_what_the_kernel_does_not_take(dev):
    scores, b = _router_inputs(ROUTER_SHAPES["v2-decode"], True, 2, dev)
    with pytest.raises(ValueError):
        mr.topk_router(scores.bfloat16(), 6)                        # dtype
    with pytest.raises(ValueError):
        mr.topk_router(scores, 6, bias=b[:8])                       # bias shape
    with pytest.raises(ValueError):
        mr.topk_router(scores, 6, bias=b.cpu())                     # device
    with pytest.raises(ValueError):
        mr.topk_router(scores.t().contiguous().t(), 6)              # layout
    with pytest.raises(ValueError, match="limits"):                 # k > 16
        mr.topk_router(scores, 17)
    with pytest.raises(ValueError, match="limits"):                 # E > 1024
        mr.topk_router(torch.rand((2, 1025), device=dev), 4)


# ------------------------------------------- scan and router backward
# the backward kernels against their plain gradients through
# chip_smoke's gates (`scan_bwd_check`: the RG-LRU value for value, NaN
# where the plain gradient has NaN; the WKV per element under WKV_BWD_TOL;
# `grad_gate` under ROUTER_BWD_TOL for the router), each call repeated bit
# for bit. (b, t, w, h0[, a[, offset]]): the forward's sweep and edges,
# with a = 1 and x = 0 ("one-x0": infinite and NaN gradients); T around
# the backward's groups of 8 rows and chunks of 64, W off its channel
# tiles of 32 and 128
RGLRU_BWD_SHAPES = {
    "sweep0": (2, 256, 64, False), "ragged-200-h0": (2, 200, 96, True),
    "t1-h0": (3, 1, 40, True), "t17-h0": (1, 17, 64, True), "t33": (3, 33, 64, False),
    "t7-w33-h0": (1, 7, 33, True), "t8-w40": (2, 8, 40, False),
    "t63-w5-h0": (2, 63, 5, True), "t65-w40": (1, 65, 40, False),
    "blocks-over-sms-h0": (1, 66, 9000, True),
    "a-zero-one-h0": (2, 100, 96, True, "zero-one"),
    "a-one-x0-h0": (2, 70, 130, True, "one-x0"), "a-one-x0": (1, 33, 64, False, "one-x0"),
    "offset1-w130-h0": (2, 70, 130, True, "sigmoid", 1),
}
# (b, t, h, k, s0[, decay]), a final-state cotangent wherever s0 is given;
# then T around the kernel's groups (G = 64 rows, 32 at K = 128) and its
# sub-chunks of 8: G - 1, G, G + 1 and 2 G + 3
RWKV6_BWD_SHAPES = {
    "sweep0": (1, 256, 2, 64, False), "sweep1": (2, 128, 4, 128, False),
    "k16-s0": (3, 70, 4, 16, True), "k32-ragged-200-s0": (2, 200, 3, 32, True),
    "t1-s0": (2, 1, 3, 64, True), "t9-s0": (1, 9, 2, 64, True),
    "grid-2x80-heads": (2, 512, 80, 64, False),
    "w-zero-one-s0": (2, 200, 3, 64, True, "zero-one"),
    "w-near0-k128-s0": (1, 130, 2, 128, True, "near0"),
    "w-main": (2, 300, 4, 64, False, "main"),
    "t63": (1, 63, 2, 64, False), "t64-s0": (2, 64, 3, 64, True),
    "t65-s0": (1, 65, 2, 64, True), "t131-zero-one-s0": (2, 131, 2, 64, True, "zero-one"),
    "k16-t64": (3, 64, 4, 16, False), "k32-t65-s0": (2, 65, 3, 32, True),
    "k128-t31-s0": (1, 31, 2, 128, True), "k128-t32": (2, 32, 1, 128, False),
    "k128-t33-s0": (1, 33, 2, 128, True), "k128-t67-zero-one": (1, 67, 2, 128, False, "zero-one"),
}
# (t, e, k, pattern, bias): the sweep, DeepSeek's prefill widths, ties,
# k = E, picks summing below 1e-9 ("tiny"), rows of -0.0 and +0.0, the
# smoke configs' 8 experts
ROUTER_BWD_SHAPES = {
    "sweep0": (256, 128, 6, "random", False), "v2-prefill": (4096, 160, 6, "random", False),
    "v3-prefill-bias": (4096, 256, 8, "random", True), "ties-bias": (64, 256, 8, "ties", True),
    "k-eq-e": (64, 8, 8, "random", False), "k16-e16-ties": (37, 16, 16, "ties", True),
    "tiny": (64, 160, 6, "tiny", False), "zeros-bias": (64, 33, 16, "zeros", True),
    "smoke-e8-bias": (24, 8, 2, "random", True),
}


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _scan_bwd(dev, name, shape, dtype, seed):
    """One backward call and its repeat, the launch count, the gate."""
    cs = _chip_smoke()
    kernel = cs.scan_bwd_fns(name)[0]
    args = cs.scan_bwd_inputs(name, shape, getattr(torch, dtype), seed, dev)
    before = kernel.launches
    got, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    for g_, x in zip(got, args):
        assert g_ is None if x is None else (g_.dtype == x.dtype and g_.shape == x.shape)
    for a_, b_ in zip(got, again):
        assert (a_ is None and b_ is None) or torch.equal(a_.view(torch.uint8),
                                                          b_.view(torch.uint8))
    gate = cs.scan_bwd_check(name, "fp32" if dtype == "float32" else "bf16", args, got)
    assert gate["ok"], gate
    return gate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RGLRU_BWD_SHAPES))
def test_rglru_bwd_kernel_matches_plain(dev, name, dtype):
    gate = _scan_bwd(dev, "rglru", RGLRU_BWD_SHAPES[name], dtype, len(name))
    if "one-x0" in name:
        assert gate["nonfinite"] > 0        # -inf and NaN, at the same places


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RWKV6_BWD_SHAPES))
def test_rwkv6_bwd_kernel_matches_plain(dev, name, dtype):
    _scan_bwd(dev, "rwkv6_wkv", RWKV6_BWD_SHAPES[name], dtype, len(name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_bwd_kernel_views_off_16_bytes(dev, dtype):
    """r, k, v, w and dout as contiguous views 3 elements into their
    storage: the kernels copy element by element in place of cp.async."""
    cs = _chip_smoke()
    args = cs.scan_bwd_inputs("rwkv6_wkv", (2, 70, 2, 64, True, "sigmoid", 3),
                              getattr(torch, dtype), 5, dev)
    assert all(args[i].data_ptr() % 16 != 0 and args[i].is_contiguous() for i in (0, 1, 2, 3, 6))
    got, again = wkv.rwkv6_wkv_bwd(*args), wkv.rwkv6_wkv_bwd(*args)
    torch.cuda.synchronize()
    assert cs.same_bits(got, again)
    gate = cs.scan_bwd_check("rwkv6_wkv", "fp32" if dtype == "float32" else "bf16", args, got)
    assert gate["ok"], gate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_bwd_kernel_views_off_16_bytes(dev, dtype):
    """x, a and dout as contiguous views 3 elements into their storage:
    the chains copy 2 bf16 or 4 fp32 bytes at a time in place of 8 or 16,
    and the gradient is still the plain one value for value."""
    cs = _chip_smoke()
    args = cs.scan_bwd_inputs("rglru", (2, 70, 130, True, "one-x0", 0, 3),
                              getattr(torch, dtype), 5, dev)
    assert all(args[i].data_ptr() % 16 != 0 and args[i].is_contiguous() for i in (0, 1, 3))
    got, again = rg.rglru_bwd(*args), rg.rglru_bwd(*args)
    torch.cuda.synchronize()
    assert cs.same_bits(got, again)
    gate = cs.scan_bwd_check("rglru", "fp32" if dtype == "float32" else "bf16", args, got)
    assert gate["ok"] and gate["nonfinite"] > 0, gate


@pytest.mark.parametrize("name", list(ROUTER_BWD_SHAPES))
def test_router_bwd_kernel_matches_plain(dev, name):
    cs = _chip_smoke()
    t, e, k, pattern, bias = ROUTER_BWD_SHAPES[name]
    scores, b = cs.router_inputs(t, e, bias, len(name), dev, pattern)
    _, idx = mr.topk_router(scores, k, bias=b)
    dw = torch.randn((t, k), generator=torch.Generator().manual_seed(3)).to(dev)
    before = mr.topk_router_bwd.launches
    got, again = mr.topk_router_bwd(scores, idx, dw), mr.topk_router_bwd(scores, idx, dw)
    torch.cuda.synchronize()
    assert mr.topk_router_bwd.launches == before + 2
    assert torch.equal(got, again)
    gate = cs.grad_gate((got,), (ref.topk_router_bwd(scores, idx, dw),), cs.ROUTER_BWD_TOL)
    assert gate["ok"], gate
    assert int((got != 0).sum(-1).max()) <= k      # the picks' columns only


def _block_inputs(dev, dtype):
    """Inputs of the three Functions that need gradients, and cotangents."""
    cs = _chip_smoke()
    dt = getattr(torch, dtype)
    x, a, h0, dx = cs.scan_bwd_inputs("rglru", (2, 70, 130, True), dt, 3, dev)
    r, k, v, w, u, s0, dout, ds = cs.scan_bwd_inputs("rwkv6_wkv", (2, 40, 3, 32, True),
                                                     dt, 4, dev)
    scores, bias = cs.router_inputs(24, 8, True, 5, dev)
    leaves = [t.clone().requires_grad_() for t in (x, a, h0, r, k, v, w, u, s0, scores,
                                                   bias)]
    return leaves, (dx, dout, ds)


def _launches():
    return [f.launches for f in (rg.rglru, rg.rglru_bwd, wkv.rwkv6_wkv, wkv.rwkv6_wkv_bwd,
                                 mr.topk_router, mr.topk_router_bwd)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_and_router_functions_launch_their_backward(dev, dtype):
    """`ops.rglru`, `ops.rwkv6_wkv` and `ops.topk_router` on inputs that
    need gradients: one forward and one backward launch each, and the
    plain gradients (a cotangent of h_T lands in dout's last row; the WKV
    with and without its final state's cotangent; the bias gets none)."""
    cs = _chip_smoke()
    leaves, (dx, dout, ds) = _block_inputs(dev, dtype)
    x, a, h0, r, k, v, w, u, s0, scores, bias = leaves
    before = _launches()
    out, h_t = ops.rglru(x, a, h0)
    o, s_fin = ops.rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)
    wt, idx = ops.topk_router(scores, 2, bias=bias)
    dh = torch.randn_like(h_t)
    dwt = torch.randn_like(wt)
    torch.autograd.backward((out, h_t, o, s_fin, wt), (dx, dh, dout, ds, dwt))
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(_launches(), before)] == [1] * 6
    assert not idx.requires_grad and bias.grad is None
    d_all = dx.clone()
    d_all[:, -1] += dh
    assert cs.same_values([t.grad for t in (x, a, h0)], ref.rglru_bwd(x, a, h0, d_all))
    form = "fp32" if dtype == "float32" else "bf16"
    want = ref.rwkv6_wkv_bwd(r, k, v, w, u, s0, dout, ds)
    gate = cs.grad_gate([t.grad for t in (r, k, v, w, u, s0)], want, cs.WKV_BWD_TOL[form])
    assert gate["ok"], gate
    gate = cs.grad_gate((scores.grad,), (ref.topk_router_bwd(scores, idx, dwt),),
                        cs.ROUTER_BWD_TOL)
    assert gate["ok"], gate
    # the model's use: the final state discarded, no cotangent for it
    for t in (r, k, v, w, u, s0):
        t.grad = None
    o, _ = ops.rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)
    o.backward(dout)
    gate = cs.grad_gate([t.grad for t in (r, k, v, w, u, s0)],
                        ref.rwkv6_wkv_bwd(r, k, v, w, u, s0, dout), cs.WKV_BWD_TOL[form])
    assert gate["ok"], gate


def test_functions_under_checkpoint(dev):
    """The three Functions inside a non-reentrant `torch.utils.checkpoint`
    (the trainer's remat): each forward kernel runs twice (the forward and
    its recomputation), each backward once, and the gradients equal those
    of the same block without the checkpoint bit for bit."""
    from torch.utils.checkpoint import checkpoint

    def block(x, a, h0, r, k, v, w, u, s0, scores, bias):
        h, _ = ops.rglru(x, a, h0)
        o, _ = ops.rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)
        wt, _ = ops.topk_router(scores, 2, bias=bias)
        return h.float().square().sum() + o.float().square().sum() + wt.square().sum()

    leaves, _ = _block_inputs(dev, "bfloat16")
    grads = torch.autograd.grad(block(*leaves), leaves[:-1])
    before = _launches()
    loss = checkpoint(block, *leaves, use_reentrant=False)
    again = torch.autograd.grad(loss, leaves[:-1])
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(_launches(), before)] == [2, 1, 2, 1, 2, 1]
    for g_, a_ in zip(grads, again):
        assert torch.equal(g_, a_)


# ---------------------------------------------------------------- ftl
# (n_seg, n_slots, entries, n): the sweep of tests/test_kernels.py, then a
# 4 TB SSD's 1862-segment directory over narrower pages, and a ragged n
FTL_SHAPES = {
    "sweep0": (64, 16, 128, 512), "sweep1": (128, 32, 256, 1024),
    "sweep2": (16, 4, 512, 256), "segments-full": (1862, 931, 512, 100_003),
}


def _ftl_inputs(shape, seed, dev, ppn_max=1 << 20):
    n_seg, n_slots, entries, n = shape
    g = torch.Generator().manual_seed(seed)
    slots = torch.randint(0, n_slots, (n_seg,), generator=g)
    directory = torch.where(torch.rand((n_seg,), generator=g) < 0.6, slots, -1)
    cache = torch.randint(0, ppn_max, (n_slots, entries), generator=g)
    lpns = torch.randint(0, n_seg * entries, (n,), generator=g)
    return [t.to(torch.int32).to(dev) for t in (lpns, directory, cache)]


@pytest.mark.parametrize("ppn_max", [1 << 20, (1 << 31) - 1], ids=["small", "int31"])
@pytest.mark.parametrize("name", list(FTL_SHAPES))
def test_ftl_kernel_matches_plain(dev, name, ppn_max):
    lpns, directory, cache = _ftl_inputs(FTL_SHAPES[name], len(name), dev, ppn_max)
    entries = cache.shape[1]
    before = ftl.ftl_lookup.launches
    ppn, hit = ftl.ftl_lookup(lpns, directory, cache, entries)
    torch.cuda.synchronize()
    assert ftl.ftl_lookup.launches == before + 1
    want_ppn, want_hit = ref.ftl_lookup(lpns, directory, cache, entries)
    assert ppn.dtype == torch.int32 and hit.dtype == torch.bool
    assert torch.equal(ppn, want_ppn) and torch.equal(hit, want_hit)


def test_ftl_kernel_out_of_range_lpns_match_plain(dev):
    directory = torch.tensor([2, 0, -1, 1, 5, 2, -7], dtype=torch.int32, device=dev)
    cache = torch.randint(0, 1 << 30, (3, 8), dtype=torch.int32, device=dev)
    lpns = torch.tensor([-100, -57, -56, -9, -1, 0, 5, 15, 31, 39, 55, 56, 57,
                         1000, 2**31 - 1, -2**31], dtype=torch.int32, device=dev)
    got = ftl.ftl_lookup(lpns, directory, cache, 8)
    want = ref.ftl_lookup(lpns, directory, cache, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the edges of the FTL kernel: (n_seg, n_slots, entries, n, offset) — N
# of 1, 3 and 5 and past a whole number of blocks, lpns a view 1, 2 or 3
# elements into its storage (off 16 bytes), a directory of 70 000
# segments (280 KB, more than an SM holds), entries not a power of two
FTL_EDGES = {"n1": (64, 16, 128, 1, 0), "n3": (64, 16, 128, 3, 0),
             "n5": (64, 16, 128, 5, 0), "n2^20+3": (1862, 931, 512, (1 << 20) + 3, 0),
             "offset1": (1862, 931, 512, 100_003, 1), "offset2": (64, 16, 128, 4097, 2),
             "offset3": (64, 16, 128, 10, 3), "dir70000": (70_000, 4096, 64, 100_003, 0),
             "entries1000": (300, 64, 1000, 50_001, 0)}


@pytest.mark.parametrize("name", list(FTL_EDGES))
def test_ftl_kernel_edges_match_plain_and_repeat(dev, name):
    n_seg, n_slots, entries, n, offset = FTL_EDGES[name]
    lpns, directory, cache = _ftl_inputs((n_seg, n_slots, entries, n + offset), len(name),
                                         dev, (1 << 31) - 1)
    lpns = lpns[offset:]
    assert lpns.storage_offset() == offset and lpns.numel() == n
    before = ftl.ftl_lookup.launches
    ppn, hit = ftl.ftl_lookup(lpns, directory, cache, entries)
    ppn2, hit2 = ftl.ftl_lookup(lpns, directory, cache, entries)
    torch.cuda.synchronize()
    assert ftl.ftl_lookup.launches == before + 2
    want_ppn, want_hit = ref.ftl_lookup(lpns, directory, cache, entries)
    assert torch.equal(ppn, want_ppn) and torch.equal(hit, want_hit)
    assert torch.equal(ppn2, ppn) and torch.equal(hit2, hit)


@pytest.mark.parametrize("entries", [8, 1000])
def test_ftl_kernel_out_of_range_lpns_at_two_entry_counts(dev, entries):
    """Negative and too-large LPNs at entries 8 (a power of two) and 1000,
    with slots below -1 and past the cache."""
    g = torch.Generator().manual_seed(entries)
    n_seg, n_slots = 7, 3
    directory = torch.tensor([2, 0, -1, 1, 5, 2, -7], dtype=torch.int32, device=dev)
    cache = torch.randint(0, 1 << 30, (n_slots, entries), generator=g).int().to(dev)
    span = n_seg * entries
    lpns = torch.randint(-2 * span, 2 * span, (4099,), generator=g)
    lpns[:2] = torch.tensor([-2**31, 2**31 - 1])
    lpns = lpns.int().to(dev)
    got = ftl.ftl_lookup(lpns, directory, cache, entries)
    want = ref.ftl_lookup(lpns, directory, cache, entries)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ftl_dispatcher_launches_for_cuda_tensors(dev):
    args = _ftl_inputs(FTL_SHAPES["sweep0"], 1, dev)
    before = ftl.ftl_lookup.launches
    ops.ftl_lookup(*args, args[2].shape[1])
    assert ftl.ftl_lookup.launches == before + 1


def test_ftl_wrapper_refuses_what_the_kernel_does_not_take(dev):
    lpns, directory, cache = _ftl_inputs(FTL_SHAPES["sweep0"], 2, dev)
    with pytest.raises(ValueError, match="entries_per_segment"):
        ftl.ftl_lookup(lpns, directory, cache, 64)                  # entries
    with pytest.raises(ValueError):
        ftl.ftl_lookup(lpns.long(), directory, cache, 128)          # dtype
    with pytest.raises(ValueError):
        ftl.ftl_lookup(lpns, directory.cpu(), cache, 128)           # device
    with pytest.raises(ValueError):
        ftl.ftl_lookup(lpns, directory, cache.t().contiguous().t(), 128)  # layout
    with pytest.raises(ValueError, match="limits"):                 # empty directory
        ftl.ftl_lookup(lpns, directory[:0], cache, 128)


# ------------------------------------------------------------ shards window
# (A, nodes, sample_mod, sample_thresh, bucket_width, mask, address set):
# one reference; the engine's window at full width (80 slots x 16 pages,
# over half padding); 4096 references at rate 1/64; every reference
# masked; a small reused set with the EMPTY marker valid among it
SW_CASES = {
    "a1": (1, 1, 1, 1, 3, "on", 8),
    "engine1280": (1280, 8, 1, 1, 3, "engine", 48),
    "a4096_rate64": (4096, 4, 64, 1, 4, "on", 5000),
    "mask_off": (300, 64, 1, 1, 3, "off", 40),
    "repeat_empty": (500, 16, 1, 1, 7, "empty", 6),
}


def _sw_inputs(k, case, seed, dev):
    a, n, mod, thresh, bw, mask_kind, span = SW_CASES[case]
    g = torch.Generator().manual_seed(seed)
    refs = torch.randint(0, span, (n, a), generator=g, dtype=torch.int64)
    if mask_kind == "engine":
        mask = torch.rand((n, a), generator=g) < 0.4
        refs = torch.where(mask, refs, ref.EMPTY_ADDR)
    elif mask_kind == "empty":
        refs = torch.where(torch.rand((n, a), generator=g) < 0.3, ref.EMPTY_ADDR, refs)
        mask = torch.ones((n, a), dtype=torch.bool)
    else:
        mask = torch.full((n, a), mask_kind == "on")
    state = [torch.full((n, k), ref.EMPTY_ADDR, dtype=torch.int64),
             torch.full((n, k), -1, dtype=torch.int32),
             torch.zeros(n, dtype=torch.int32), torch.zeros((n, 16)),
             torch.zeros(n), torch.zeros(n)]
    return ([t.to(dev) for t in state] + [refs.to(dev), mask.to(dev)],
            (mod, thresh, bw))


@pytest.mark.parametrize("case", list(SW_CASES))
@pytest.mark.parametrize("k", [1, 31, 48, 128, 256])
def test_shards_window_matches_plain(dev, k, case):
    """Two windows, the second from the first's state (decayed): every
    output of the kernel equals the plain version's bit for bit."""
    args, consts = _sw_inputs(k, case, k, dev)
    state = args[:6]
    for w in range(2):
        before = sw.shards_window.launches
        got = sw.shards_window(*state, *args[6:], *consts)
        again = sw.shards_window(*state, *args[6:], *consts)
        torch.cuda.synchronize()
        assert sw.shards_window.launches == before + 2
        want = ref.shards_window(*state, *args[6:], *consts)
        for name, g_, a_, w_ in zip(("addrs", "last_seen", "clock", "hist",
                                     "cold", "total"), got, again, want):
            assert g_.dtype == w_.dtype and torch.equal(g_, w_), (w, name)
            assert torch.equal(g_, a_), (w, name)
        state = list(got)
        state[3:] = [t * 0.85 for t in state[3:]]
    if case != "mask_off":
        assert int(got[2].sum()) > 0
    else:
        assert int(got[2].sum()) == 0 and float(got[5].sum()) == 0.0


def test_shards_window_update_window_equals_cpu(dev):
    """`windows.update_window` on the card (decay, then one launch for
    every node of every shard) equals the CPU's plain path bit for bit."""
    from repro_torch.core import shards_mrc
    from repro_torch.telemetry import want, windows
    cfg = windows.TelemetryConfig(k=48, buckets=16, sample_mod=1, sample_thresh=1,
                                  bucket_width=3, decay=0.9, min_total=2.0)
    g = torch.Generator().manual_seed(0)
    gs = shards_mrc.init(cfg.k, cfg.buckets, lead=(2, 4), device=dev)
    cs = shards_mrc.init(cfg.k, cfg.buckets, lead=(2, 4), device="cpu")
    for _ in range(4):
        pt = torch.randint(-1, 48, (2, 4, 160), generator=g, dtype=torch.int32)
        before = sw.shards_window.launches
        gs = windows.update_window(gs, pt.to(dev), cfg)
        assert sw.shards_window.launches == before + 1
        cs = windows.update_window(cs, pt, cfg)
        for f in cs._fields:
            assert torch.equal(getattr(gs, f).cpu(), getattr(cs, f)), f
        assert torch.equal(want.want_entries(gs, cfg).cpu(), want.want_entries(cs, cfg))


def test_shards_window_dispatcher_launches_for_cuda_tensors(dev):
    args, consts = _sw_inputs(48, "engine1280", 3, dev)
    before = sw.shards_window.launches
    ops.shards_window(*args, *consts)
    assert sw.shards_window.launches == before + 1


def test_shards_window_wrapper_refuses_what_the_kernel_does_not_take(dev):
    args, consts = _sw_inputs(48, "a1", 1, dev)
    with pytest.raises(ValueError, match="CUDA kernel"):
        sw.shards_window(*[t.cpu() for t in args], *consts)
    bad = list(args)
    bad[0] = bad[0].int()
    with pytest.raises(ValueError, match="addrs"):
        sw.shards_window(*bad, *consts)
    bad = list(args)
    bad[7] = bad[7][:, :0]
    with pytest.raises(ValueError, match="differ in shape"):
        sw.shards_window(*bad, *consts)
    big, _ = _sw_inputs(sw.MAX_K_H100 + 1, "a1", 1, dev)
    with pytest.raises(ValueError, match="limits"):
        sw.shards_window(*big, *consts)


@pytest.mark.parametrize("k", [8192, sw.MAX_K_H100])
def test_shards_window_takes_tables_past_48kb(dev, k):
    """A table past the 48 KB of shared memory a block gets by default
    (the engine's k = pages_per_replica at a large pool) opts in to more
    and still equals the plain version bit for bit."""
    args, consts = _sw_inputs(k, "engine1280", 5, dev)
    got = sw.shards_window(*args, *consts)
    want = ref.shards_window(*args, *consts)
    for name, g_, w_ in zip(("addrs", "last_seen", "clock", "hist", "cold",
                             "total"), got, want):
        assert torch.equal(g_, w_), name
    assert int(got[2].sum()) > 0
