"""The port's FTL lookup kernel (`csrc/ftl_lookup.cu`) emulated with numpy
on its edge inputs, against the port's plain version
(`repro_torch.kernels.ref.ftl_lookup`), the jnp oracle and, where its fp32
one-hot walk is exact (PPNs below 2^24, LPNs in range), the Pallas kernel
in interpret mode, on the CPU, bit for bit.

The emulation follows the kernel's C entry and threads: a grid of
ceil(N / 256) blocks of 256 threads, thread i taking LPN i (any
contiguous `lpns`, a view 1, 2 or 3 elements into its storage included);
per LPN the floored segment and offset by a truncating int32 division and
remainder floored by hand, a negative segment wrapped once and then
clamped, the directory entry read (70 000 segments too, more than an SM
holds), and the mapping entry of a hit, its slot clamped into the cache.
Every LPN must be taken exactly once. Also `chip_smoke.py`'s byte count
for the FTL row's bound, its walk of a bench's builds and its reading of
nvcc's report for a kernel that is no template."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ftl_lookup import ftl_lookup as pallas_ftl
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

THREADS = 256
ROOT = Path(__file__).resolve().parents[1]
# name -> (n_seg, n_slots, entries, n, offset); the Pallas kernel joins
# where PPNs stay below 2^24 (`small`)
CASES = {f"n{n}-offset{o}": (64, 16, 128, n, o) for n in (1, 3, 5, 4, 9, 1030)
         for o in (0, 1, 2, 3)}
CASES.update({"n2^20+3": (1862, 931, 512, (1 << 20) + 3, 0),
              "offset1-big": (1862, 931, 512, 100_003, 1),
              "dir70000": (70_000, 256, 64, 515, 0),
              "dir70000-offset3": (70_000, 256, 64, 4099, 3),
              "entries1000": (300, 64, 1000, 5001, 0),
              "entries1000-offset2": (300, 64, 1000, 1027, 2)})


def seg_off(lpn: np.ndarray, entries: int):
    """Floored segment and offset as the kernel takes them: C's truncating
    int32 division and remainder, then one step down where the remainder
    is negative."""
    lpn = lpn.astype(np.int32)
    q = (np.abs(lpn.astype(np.int64)) // entries * np.sign(lpn)).astype(np.int32)
    r = (lpn.astype(np.int64) - q.astype(np.int64) * entries).astype(np.int32)
    neg = r < 0
    return np.where(neg, q - 1, q).astype(np.int32), np.where(neg, r + entries, r).astype(np.int32)


def lookup(lpn, directory, cache, entries):
    """The LPNs' walks, one thread's each."""
    n_seg, n_slots = directory.shape[0], cache.shape[0]
    seg, off = seg_off(lpn, entries)
    seg = np.where(seg < 0, seg + n_seg, seg).clip(0, n_seg - 1)
    slot = directory[seg]
    hit = slot >= 0
    ppn = np.where(hit, cache[np.minimum(np.maximum(slot, 0), n_slots - 1), off], -1)
    return ppn.astype(np.int32), hit


def emulate(lpns, directory, cache, entries):
    """(ppn, hit, times each LPN was taken) over the C entry's grid."""
    n = lpns.shape[0]
    ppn = np.full(n, 12345, np.int32)
    hit = np.zeros(n, bool)
    taken = np.zeros(n, np.int64)
    blocks = -(-n // THREADS)
    i = (np.arange(blocks)[:, None] * THREADS + np.arange(THREADS)).ravel()
    i = i[i < n]                      # a thread past N returns at once
    ppn[i], hit[i] = lookup(lpns[i], directory, cache, entries)
    np.add.at(taken, i, 1)
    return ppn, hit, taken


def _inputs(n_seg, n_slots, entries, n, offset, seed, ppn_max, out_of_range=False):
    rng = np.random.default_rng(seed)
    directory = np.where(rng.random(n_seg) < 0.6, rng.integers(0, n_slots, n_seg), -1)
    span = n_seg * entries
    lo, hi = (-2 * span, 2 * span) if out_of_range else (0, span)
    store = rng.integers(max(lo, -2**31), min(hi, 2**31 - 1), n + offset)
    if out_of_range:
        directory[::5], directory[1::7] = -7, n_slots + 3
        store[:2] = [-2**31, 2**31 - 1]
    cache = rng.integers(0, ppn_max, (n_slots, entries))
    return (store.astype(np.int32)[offset:], directory.astype(np.int32),
            cache.astype(np.int32))


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _check(lpns, directory, cache, entries, pallas):
    ppn, hit, taken = emulate(lpns, directory, cache, entries)
    assert (taken == 1).all()
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (lpns, directory, cache)]
    plain = tref.ftl_lookup(*t, entries)
    np.testing.assert_array_equal(ppn, plain[0].numpy())
    np.testing.assert_array_equal(hit, plain[1].numpy())
    j = [jnp.asarray(a) for a in (lpns, directory, cache)]
    oracle = jref.ftl_lookup(*j, entries)
    np.testing.assert_array_equal(ppn, np.asarray(oracle[0]))
    np.testing.assert_array_equal(hit, np.asarray(oracle[1]))
    if pallas:
        got = pallas_ftl(*j, entries, interpret=True)
        np.testing.assert_array_equal(ppn, np.asarray(got[0]))
        np.testing.assert_array_equal(hit, np.asarray(got[1]))
    return hit


@pytest.mark.parametrize("ppns", ["small", "int31"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernel_matches_plain_oracle_and_pallas(name, ppns):
    n_seg, n_slots, entries, n, offset = CASES[name]
    ppn_max = (1 << 24) if ppns == "small" else (1 << 31) - 1
    lpns, directory, cache = _inputs(n_seg, n_slots, entries, n, offset,
                                     seed=len(name), ppn_max=ppn_max)
    # the Pallas kernel in interpret mode at the smaller sizes only
    pallas = ppns == "small" and n <= 5001
    hit = _check(lpns, directory, cache, entries, pallas)
    if n > 100:
        assert 0 < hit.sum() < n


@pytest.mark.parametrize("entries", [8, 512, 1000, 7])
def test_emulated_out_of_range_lpns(entries):
    """Negative and too-large LPNs (int32's extremes included) with slots
    below -1 and past the cache, at entry counts of powers of two and not:
    against the plain version and the oracle (the Pallas kernel gives an
    out-of-range segment slot 0, so it is left out)."""
    lpns, directory, cache = _inputs(50, 9, entries, 4099, 1, seed=entries,
                                     ppn_max=(1 << 31) - 1, out_of_range=True)
    _check(lpns, directory, cache, entries, pallas=False)


@pytest.mark.parametrize("entries", [1, 2, 64, 524288, 1 << 30, 7, 1000, 2**31 - 1])
def test_segment_and_offset_floor_as_division_does(entries):
    """The truncating division floored by hand gives the floored quotient
    and remainder of every int32, negatives included."""
    rng = np.random.default_rng(entries % 1000)
    lpn = np.concatenate([rng.integers(-2**31, 2**31, 20000),
                          [-2**31, 2**31 - 1, -1, 0, 1, -entries, entries - 1]]).astype(np.int32)
    seg, off = seg_off(lpn, entries)
    np.testing.assert_array_equal(seg, np.floor_divide(lpn.astype(np.int64), entries))
    np.testing.assert_array_equal(off, np.mod(lpn.astype(np.int64), entries))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 255, 256, 257, 1023, 1026])
def test_grid_takes_each_lpn_once(n):
    lpns, directory, cache = _inputs(64, 16, 128, n, 0, seed=n, ppn_max=1 << 20)
    assert (emulate(lpns, directory, cache, 128)[2] == 1).all()


@pytest.mark.parametrize("n_seg", [1862, 70_000])
def test_bound_reads_the_directory_once(n_seg):
    """`chip_smoke.ftl_bytes`, the FTL row's bound: each LPN read, its PPN
    and hit written (9 B), the directory once, 4 B per hit's mapping
    entry, or 32 B, a whole sector, per gather."""
    chip_smoke = _chip_smoke()
    n, hits = 1 << 20, 1000
    assert chip_smoke.ftl_bytes(n, n_seg, hits) == 9 * n + 4 * n_seg + 4 * hits
    assert chip_smoke.ftl_bytes(n, n_seg, hits, per_gather=32) == (
        9 * n + 4 * n_seg + 32 * hits)
    assert chip_smoke.ftl_bytes(n, n_seg, 0) == chip_smoke.ftl_bytes(n, n_seg, 0, 32)


def test_bench_walk_goes_forward_then_back():
    chip_smoke = _chip_smoke()
    assert list(chip_smoke.walk(["parent", "change"], 2)) == [
        (0, "parent"), (0, "change"), (0, "change"), (0, "parent"),
        (1, "parent"), (1, "change"), (1, "change"), (1, "parent")]


def test_ptxas_rows_reads_a_kernel_that_is_no_template():
    chip_smoke = _chip_smoke()
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN36_INTERNAL_0_ftl_lookup_cu_2f_GLOBAL__N_110ftl_kernelEPKiS1_S1_PiPhliii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 18 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN36_INTERNAL_0_moe_router_cu_2f_GLOBAL__N_113router_kernelILi5EEEvPKfS3_PiPfiii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers"])
    assert chip_smoke.ptxas_rows(log, "ftl_kernel|router_kernel") == [
        {"kernel": "ftl_kernel", "spill_stores": 0, "spill_loads": 0, "registers": 18},
        {"kernel": "router_kernel<5>", "spill_stores": 8, "spill_loads": 4, "registers": 40}]
