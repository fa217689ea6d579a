"""The port's hand-written CUDA kernels (paged attention and prefill flash
attention) against their plain PyTorch versions, on the card. Marked
``cuda``: they skip where there is no CUDA device, and import neither JAX
nor `repro`, so the card's machine runs them as they are:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Paged attention: the sweeps of tests/test_kernels.py plus the serving
engine's default layer (H4/KV2/D32) and qwen3-14b's attention width
(H40/KV8/D128), pages of 4, 8 and 16 slots, tables with holes and a row of
length 0. Flash attention: the sweep of tests/test_kernels.py under its
three masks, head_dim 80 and 16, ragged lengths and rows with no valid
key."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

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


def _inputs(form, shape, seed, dev):
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
    args = [t.to(dev) for t in (q, *planes, table, lengths)]
    return args, kw


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
