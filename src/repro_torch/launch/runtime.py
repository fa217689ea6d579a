"""Process-level serving-runtime context: the mesh used by sharded decode
(port of `repro.launch.runtime`).

`attention.mla_decode` consults it to choose the sequence-sharded
(flash-combine) path when the mesh has a "model" axis; unset (the
default) it runs the local path.
"""
from __future__ import annotations

_SERVE_MESH = None


def set_serve_mesh(mesh) -> None:
    global _SERVE_MESH
    _SERVE_MESH = mesh


def get_serve_mesh():
    return _SERVE_MESH
