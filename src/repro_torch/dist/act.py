"""Activation sharding constraints (sequence-parallel residual stream),
counterpart of ``repro/dist/act.py``.

The model executors call ``act.constrain(x)`` on the residual stream
between layers (``models/transformer.py``, ``models/encdec.py``). Outside
an ``activation_spec`` context, and on a plain tensor, that is an
identity: training on the data axes pays nothing. Inside one, on a
DTensor (the dry run's model axis, ``launch/dryrun.py``, runs
``(None, None, "model")``: the residual's feature dim sharded over the
tensor-parallel axis) it redistributes the tensor to the spec, so
between layers each device keeps 1/tp of the residual stream — the
activation-memory side of tensor parallelism.

The spec is right-aligned to the tensor's rank and sanitized against the
tensor's mesh, as the reference sanitizes against its ambient mesh: a
non-divisible feature dim degrades to replicated rather than failing.
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.dist.sharding import Mesh, placements, sanitize_spec

_STATE = threading.local()


def current_spec():
    """The active activation spec (a tuple of entries), or None outside
    any context."""
    return getattr(_STATE, "spec", None)


@contextlib.contextmanager
def activation_spec(spec):
    """Make ``spec`` the activation constraint inside the block. ``spec``
    may be None (an explicit no-op, e.g. decode shapes, whose one-token
    residual is too small to shard). Contexts nest; the previous spec is
    restored on exit."""
    prev = getattr(_STATE, "spec", None)
    _STATE.spec = None if spec is None else tuple(spec)
    try:
        yield
    finally:
        _STATE.spec = prev


def padded_spec(spec, ndim: int) -> tuple:
    """``spec`` right-aligned to rank ``ndim``: leading dims padded with
    None (batch and sequence stay unconstrained), an over-long spec
    trimmed from the left."""
    entries = list(spec)
    if len(entries) > ndim:
        entries = entries[len(entries) - ndim:]
    return tuple([None] * (ndim - len(entries)) + entries)


def constrain(x):
    """Apply the active activation constraint to ``x`` (identity if none,
    or if ``x`` is a plain tensor, which has no mesh to be placed on)."""
    spec = current_spec()
    if spec is None:
        return x
    mesh = getattr(x, "device_mesh", None)
    if mesh is None:
        return x
    names = tuple(mesh.mesh_dim_names)
    entries = padded_spec(spec, x.ndim)
    if all(e is None for e in entries):
        return x
    want = placements(sanitize_spec(
        entries, tuple(x.shape), Mesh(names, tuple(mesh.shape))), names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
