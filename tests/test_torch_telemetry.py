"""The telemetry plane of the port against the JAX reference, on the CPU:
`core.shards_mrc.update` (the plain SHARDS scan) against the compiled
reference on seeded streams — overflow past K, masks, sample_mod 64, 4
and 1, bucket_width 3, 4, 7 and 8, addresses at and above 2^31 and the
EMPTY marker itself — with every state leaf bit for bit; the batched
`windows.update_window` (one `kernels.ops.shards_window` call for every
node), `mrc_batch`, `miss_at_batch` and `want.want_entries` with and
without a weight, bit for bit; and `traces.*`, whose arrays must be equal.

The reference's compiled scan multiplies the distance by one float32
factor where its source divides by the rate and the bucket width
(`kernels.ref.shards_constants`), and its cumsum sums each prefix left to
right (`shards_mrc.prefix_sum`): with both, the float leaves land on the
reference's bits, so every comparison here is exact."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shards_mrc as JS
from repro.telemetry import traces as JT
from repro.telemetry import want as JW
from repro.telemetry import windows as JWin
from repro_torch.core import shards_mrc as TS
from repro_torch.kernels import ref as tref
from repro_torch.telemetry import traces as TT
from repro_torch.telemetry import want as TW
from repro_torch.telemetry import windows as TWin

jax.config.update("jax_platform_name", "cpu")

U32 = np.uint32(0xFFFFFFFF)


def _port_state(js) -> TS.ShardsState:
    """The port's state holding a reference state's values."""
    a = {f: np.asarray(getattr(js, f)) for f in js._fields}
    return TS.ShardsState(
        addrs=torch.from_numpy(a["addrs"].astype(np.int64)),
        last_seen=torch.from_numpy(a["last_seen"].copy()),
        clock=torch.from_numpy(np.array(a["clock"])),
        hist=torch.from_numpy(a["hist"].copy()),
        cold=torch.from_numpy(np.array(a["cold"])),
        total=torch.from_numpy(np.array(a["total"])))


def assert_state_equal(js, ts, where=""):
    """Every leaf bit for bit (addrs: uint32 against int64 values)."""
    np.testing.assert_array_equal(ts.addrs.numpy(),
                                  np.asarray(js.addrs).astype(np.int64),
                                  err_msg=f"{where} addrs")
    for f in ("last_seen", "clock", "hist", "cold", "total"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {f}")


def _stream(rng, n, kind):
    """uint32 references: a small reused set, a set larger than the table
    (overflow past K), addresses at and above 2^31, the EMPTY marker and
    its neighbours mixed in."""
    if kind == "small":
        return rng.integers(0, 40, n).astype(np.uint32)
    if kind == "overflow":
        return rng.integers(0, 600, n).astype(np.uint32)
    if kind == "high":
        up = rng.integers(0, 2, n) * ((1 << 32) - 120)
        return ((rng.integers(0, 50, n) + (1 << 31) + up) % (1 << 32)).astype(np.uint32)
    out = rng.integers(0, 30, n).astype(np.uint32)
    pick = rng.random(n)
    out[pick < 0.15] = U32
    out[(pick >= 0.15) & (pick < 0.25)] = U32 - 1
    return out


_update = jax.jit(JS.update, static_argnames=("sample_mod", "sample_thresh",
                                              "bucket_width"))


def test_hash_matches_uint32_reference():
    a = np.array([0, 1, 2, 65535, 65536, 2**31 - 1, 2**31, 2**31 + 7,
                  2**32 - 2, 2**32 - 1, 123456789, 3735928559], np.uint32)
    want = np.asarray(JS._hash(jnp.asarray(a)))
    got = TS._hash(torch.from_numpy(a.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        TS._hash(torch.from_numpy(a.astype(np.int64))).numpy(),
        np.asarray(JS._hash(jnp.asarray(a))).astype(np.int64))


KINDS = ["small", "overflow", "high", "empty"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sample", [(64, 4), (4, 1), (1, 1), (64, 3)])
@pytest.mark.parametrize("bw", [3, 4, 7, 8])
def test_update_matches_reference(kind, sample, bw):
    mod, thresh = sample
    rng = np.random.default_rng([KINDS.index(kind), mod, thresh, bw])
    k, buckets = 24, 16
    js = JS.init(k, buckets)
    ts = TS.init(k, buckets, device="cpu")
    for w in range(3):
        a = _stream(rng, 150, kind)
        mask = rng.random(150) < 0.8 if w != 1 else None
        jm = None if mask is None else jnp.asarray(mask)
        js = _update(js, jnp.asarray(a), sample_mod=mod, sample_thresh=thresh,
                     bucket_width=bw, mask=jm)
        ts = TS.update(ts, torch.from_numpy(a.astype(np.int64)), sample_mod=mod,
                       sample_thresh=thresh, bucket_width=bw,
                       mask=None if mask is None else torch.from_numpy(mask))
        assert_state_equal(js, ts, f"window {w}")
    if kind in ("small", "empty"):
        # a reused set at full rate must reach the histogram
        assert mod > 4 or float(ts.hist.sum()) > 0


def test_update_from_mid_state_and_table_of_one():
    """A table of one row (every miss evicts it) and a state carried from
    the reference's."""
    rng = np.random.default_rng(11)
    js = JS.init(1, 4)
    a = rng.integers(0, 3, 60).astype(np.uint32)
    js = _update(js, jnp.asarray(a), sample_mod=1, sample_thresh=1, bucket_width=1)
    ts = TS.update(_port_state(JS.init(1, 4)), torch.from_numpy(a.astype(np.int64)),
                   sample_mod=1, sample_thresh=1, bucket_width=1)
    assert_state_equal(js, ts)
    a2 = rng.integers(0, 5, 40).astype(np.uint32)
    js2 = _update(js, jnp.asarray(a2), sample_mod=4, sample_thresh=3, bucket_width=3)
    ts2 = TS.update(_port_state(js), torch.from_numpy(a2.astype(np.int64)),
                    sample_mod=4, sample_thresh=3, bucket_width=3)
    assert_state_equal(js2, ts2)


def test_scale_constant_is_the_compiled_reciprocal_product():
    """The float32 factor the compiled scan multiplies by, read off the
    reference's HLO for one non-trivial case (2/7 rate, width 4)."""
    st = JS.init(8, 4)
    hlo = jax.jit(lambda s, a: JS.update(s, a, sample_mod=7, sample_thresh=2,
                                         bucket_width=4)
                  ).lower(st, jnp.zeros((4,), jnp.uint32)).compile().as_text()
    scale, inv = tref.shards_constants(7, 2, 4)
    consts = {np.float32(c) for c in re.findall(r"f32\[\] constant\(([-\d.e+]+)\)", hlo)}
    assert np.float32(scale) in consts and np.float32(inv) in consts
    assert np.float32(scale) == np.float32(0.87499994)
    assert np.float32(inv) == np.float32(3.5)


TCFG = JWin.TelemetryConfig(k=32, buckets=16, sample_mod=4, sample_thresh=1,
                            bucket_width=4, decay=0.85, min_total=2.0)
ENGINE_TCFG = JWin.TelemetryConfig(k=48, buckets=16, sample_mod=1,
                                   sample_thresh=1, bucket_width=3, decay=0.9,
                                   min_total=2.0)


def _port_tcfg(cfg):
    return TWin.TelemetryConfig(*cfg)


@pytest.mark.parametrize("cfg", [TCFG, ENGINE_TCFG], ids=["sim", "engine"])
def test_update_window_mrc_miss_and_want(cfg):
    """Five windows of a padded trace over 6 nodes (one idle): the batched
    state, the curves, the miss ratios at several cache sizes and the
    wants with and without a weight, all bit for bit."""
    tcfg = _port_tcfg(cfg)
    n, a_w = 6, 96
    sched = [JT.table2_phases(0.4, 5, 60, 10, 80, node_index=i, n_nodes=n)
             for i in range(n - 1)] + [[]]
    trace = np.array(JT.synth_trace(5, sched, a_w, seed=3))
    trace[:, 2, ::7] = U32          # more padding inside a live node
    js = JWin.init_batch(n, cfg)
    ts = TWin.init_batch(n, tcfg, device="cpu")
    upd = jax.jit(JWin.update_window, static_argnums=2)
    want_j = jax.jit(JW.want_entries, static_argnums=1)
    rng = np.random.default_rng(0)
    for t in range(5):
        js = upd(js, jnp.asarray(trace[t]), cfg)
        ts = TWin.update_window(ts, torch.from_numpy(trace[t].astype(np.int64)), tcfg)
        assert_state_equal(js, ts, f"window {t}")
        np.testing.assert_array_equal(
            TWin.mrc_batch(ts, tcfg).numpy(),
            np.asarray(jax.jit(JWin.mrc_batch, static_argnums=1)(js, cfg)))
        sizes = rng.integers(0, cfg.buckets * cfg.bucket_width + 20, n).astype(np.int32)
        np.testing.assert_array_equal(
            TWin.miss_at_batch(ts, torch.from_numpy(sizes), tcfg).numpy(),
            np.asarray(jax.jit(JWin.miss_at_batch, static_argnums=2)(
                js, jnp.asarray(sizes), cfg)))
        np.testing.assert_array_equal(TW.want_entries(ts, tcfg).numpy(),
                                      np.asarray(want_j(js, cfg)))
        w = (rng.random(n) * 3).astype(np.float32)
        np.testing.assert_array_equal(
            TW.want_entries(ts, tcfg, weight=torch.from_numpy(w)).numpy(),
            np.asarray(want_j(js, cfg, jnp.asarray(w))))
    assert float(TW.want_entries(ts, tcfg)[-1]) == 0.0   # idle node
    assert (TW.want_entries(ts, tcfg)[:-1] > 0).any()


def test_update_window_int32_pad_is_empty_ref():
    """An int32 -1 (a dead page-table slot) becomes 0xFFFFFFFF, masked by
    default, as under the reference's cast to uint32."""
    cfg = TWin.TelemetryConfig(k=8, buckets=4, sample_mod=1, sample_thresh=1,
                               bucket_width=2)
    pt = torch.tensor([[3, -1, 3, 5, -1, 3]], dtype=torch.int32)
    got = TWin.update_window(TWin.init_batch(1, cfg, device="cpu"), pt, cfg)
    js = JWin.update_window(JWin.init_batch(1, JWin.TelemetryConfig(*cfg)),
                            jnp.asarray(pt.numpy()).astype(jnp.uint32),
                            JWin.TelemetryConfig(*cfg))
    assert_state_equal(js, got)
    assert int(got.clock[0]) == 4


def test_prefix_sum_is_serial_float32():
    x = torch.tensor([[1e8, 1.0, -1e8, 3.0, 0.1, 0.2]], dtype=torch.float32)
    got = TS.prefix_sum(x)
    acc, want = np.float32(0), []
    for v in x[0].numpy():
        acc = np.float32(acc + v)
        want.append(acc)
    np.testing.assert_array_equal(got[0].numpy(), np.array(want, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_traces_equal_reference(seed):
    sched = [JT.table2_phases(0.3, 40, JT.segments(2), JT.segments(0.25), 64,
                              node_index=i, n_nodes=3) for i in range(3)]
    sched.append(JT.phase_change(40, 10, 25, 900, 60, 64))
    sched.append([JT.TracePhase(0, 300, 50, sequential=True),
                  JT.TracePhase(20, 200, 70, zipf_a=0.0, offset=1000)])
    sched.append([])
    want = np.asarray(JT.synth_trace(40, sched, 64, seed=seed))
    tsched = [[TT.TracePhase(*p) for p in s] for s in sched]
    got = TT.synth_trace(40, tsched, 64, seed=seed)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert TT.table2_phases(0.3, 40, 256, 32, 64, 1, 3) == [
        TT.TracePhase(*p) for p in JT.table2_phases(0.3, 40, 256, 32, 64, 1, 3)]
    assert TT.table2_phases(1.0, 40, 256, 32, 64) == [
        TT.TracePhase(*p) for p in JT.table2_phases(1.0, 40, 256, 32, 64)]
    assert TT.phase_change(50, 5, 9, 100, 10, 20) == [
        TT.TracePhase(*p) for p in JT.phase_change(50, 5, 9, 100, 10, 20)]
    assert TT.segments(1.5) == JT.segments(1.5) == 192
