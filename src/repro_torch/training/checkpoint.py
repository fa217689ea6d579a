"""Checkpoint/restart for the training state.

Port of `repro.training.checkpoint`, in its layout: two slots,
``slot{step % 2}/shard0.npz`` (the state's leaves as ``leaf_{i}`` in the
reference's flatten order: dict keys sorted, NamedTuple fields in order)
and ``manifest.json`` ({"step", "n_leaves", "extra"}). A save first
unlinks the slot's manifest and syncs the slot's directory, so that the
slot reads as incomplete while its leaves change; then each file is
written to ``.tmp``, synced and moved into place with ``os.replace``, the
manifest last (its replace is the commit). A crash at any point of a save
leaves its slot incomplete, never a manifest naming a step other than its
leaves', and the other slot whole; `restore` takes the newest slot that
has both files. The slots alternate by ``step % 2``: a caller whose saves
all fall on one parity (the launcher with an even ``ckpt_every``) keeps
one slot, and a crash mid-save then leaves no complete checkpoint.

bf16 leaves are stored as their raw 16 bits in a 2-byte void dtype
(``|V2``), the bytes and dtype that the reference's ``np.asarray`` of an
ml_dtypes bfloat16 array writes; reading takes those bits back, so no
ml_dtypes is needed on either side. Each package restores the other's
checkpoints bit for bit (fp32, and bf16 in this direction; the reference's
own restore cannot cast a ``|V2`` leaf).
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from . import tree as tr

_BF16_BITS = np.dtype("V2")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16_BITS)
    return x.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bf16 leaf needs 16-bit data; got {a.dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(like.dtype)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"leaf of shape {tuple(t.shape)} where {tuple(like.shape)} "
                         "was expected")
    return t.to(like.device)


def save(ckpt_dir: str | Path, state: Any, step: int, extra: dict | None = None) -> None:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    slot = ckpt_dir / f"slot{step % 2}"
    slot.mkdir(exist_ok=True)
    # the slot is incomplete from here until the new manifest lands: a
    # crash cannot leave the old manifest over the new leaves
    (slot / "manifest.json").unlink(missing_ok=True)
    _fsync_dir(slot)
    leaves = tr.leaves(state)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    tmp = slot / "shard0.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, slot / "shard0.npz")
    manifest = {"step": step, "n_leaves": len(leaves), "extra": extra or {}}
    mtmp = slot / "manifest.json.tmp"
    with open(mtmp, "w") as f:
        f.write(json.dumps(manifest))
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, slot / "manifest.json")   # manifest last == commit record
    _fsync_dir(slot)


def _fsync_dir(path: Path) -> None:
    """Make a directory's entries (an unlink, a replace) durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    best = None
    for slot in ckpt_dir.glob("slot*"):
        m = slot / "manifest.json"
        if m.exists() and (slot / "shard0.npz").exists():
            step = json.loads(m.read_text())["step"]
            best = step if best is None else max(best, step)
    return best


def restore(ckpt_dir: str | Path, state_like: Any) -> tuple[Any, int] | None:
    """Restore into the structure, dtypes and devices of ``state_like``:
    (state, step), or None when no slot is complete."""
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = ckpt_dir / f"slot{step % 2}" / "shard0.npz"
    leaves, treedef = tr.flatten(state_like)
    # a thread a leaf, each with its own handle on the file (np.load's reads,
    # CRC checks and copies release the GIL): a restore of h2o-danube-1.8b's
    # 18.3 GB state ran at 0.4 GB/s leaf after leaf
    with ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1)) as pool:
        restored = list(pool.map(lambda il: _read_leaf(path, *il), enumerate(leaves)))
    return tr.unflatten(treedef, restored), step


def _read_leaf(path: Path, i: int, like: torch.Tensor) -> torch.Tensor:
    with np.load(path) as data:
        return _from_numpy(data[f"leaf_{i}"], like)
