"""Placement rules for sharded training (counterpart of
``repro/dist/sharding.py``, the part that ``core/gspmd.py`` reads).

The reference places every leaf on a ``(pod, data, model)`` mesh with a
``PartitionSpec``; the port's ranks form the data axes alone (``data``,
or ``pod`` x ``data``), so a spec here is a tuple of entries, one a dim:
an axis name, a tuple of names, or None. :class:`Mesh` carries what the
rules read of a ``jax.sharding.Mesh``: the axis names in mesh order and
their sizes.

- :func:`param_spec` is the reference's rule table (tensor parallelism
  over ``model``: heads, the FFN hidden dim, experts, the vocab; the
  reference's ``set_replicate_attn`` ablation of the dry run is not
  copied);
- :func:`sanitize_spec` repairs a spec for a shape: an axis that is not
  on the mesh drops (so on the port's pure-data meshes every ``model``
  entry does), one that does not divide its dim moves to the nearest
  free dim it divides, or drops;
- :func:`fsdp_param_spec` adds the data axes on the largest free dim
  (preferring dims they divide), the reference's FSDP rule;
  :func:`fsdp_dim` is the dim it picks for a leaf on k ranks, or None
  when the leaf stays whole.

The port holds a decoder's layers one dict a layer where the reference
stacks them; the rules read the leaf as it is held. The sequence-
parallel activation constraints (``repro/dist/act.py``) act on the
``model`` axis alone and are identities without one: not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """Axis names in mesh order and their sizes."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def data_mesh(k: int) -> Mesh:
    """The port's mesh of k ranks on one data axis (``pod`` x ``data``
    shards a leaf over the product of the two, in the same rank order)."""
    return Mesh(("data",), (k,))


# ---------------------------------------------------------------------------
# mesh topology
# ---------------------------------------------------------------------------

def dp_axes_of(mesh) -> tuple:
    """Data-parallel axes (everything but ``model``), in mesh order."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def dp_size_of(mesh) -> int:
    """Total data-parallel world size (product over data+pod axes)."""
    k = 1
    for a in dp_axes_of(mesh):
        k *= mesh.shape[a]
    return k


def _extent(mesh, entry) -> int:
    """Mesh extent of one spec entry (axis name or tuple of them)."""
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        k = 1
        for a in entry:
            k *= mesh.shape[a]
        return k
    return mesh.shape[entry]


# ---------------------------------------------------------------------------
# spec sanitizer
# ---------------------------------------------------------------------------

def sanitize_spec(spec, shape, mesh) -> tuple:
    """Repair ``spec`` for ``shape`` on ``mesh``: every surviving mesh axis
    divides its dim, or it is gone.

    An entry whose dim its extent does not divide moves to the nearest
    *free* divisible dim — scanning right first, then left — or drops
    when nothing divides. Axes absent from the mesh drop. Trailing
    ``None``s are stripped."""
    entries = list(spec)[:len(shape)]
    entries += [None] * (len(shape) - len(entries))
    for i, e in enumerate(entries):
        if e is None:
            continue
        if isinstance(e, (tuple, list)):
            e = tuple(a for a in e if a in mesh.shape)
            e = e[0] if len(e) == 1 else (e or None)
        elif e not in mesh.shape:
            e = None
        entries[i] = e
        if e is None:
            continue
        k = _extent(mesh, e)
        if k <= 1 or shape[i] % k == 0:
            continue
        cands = [j for j in range(i + 1, len(entries))
                 if entries[j] is None and shape[j] % k == 0]
        cands += [j for j in range(i - 1, -1, -1)
                  if entries[j] is None and shape[j] % k == 0]
        entries[i] = None
        if cands:
            entries[cands[0]] = e
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# ---------------------------------------------------------------------------
# parameter rule engine
# ---------------------------------------------------------------------------

def _base_rule(names: list, key: str, ndim: int) -> tuple:
    """Spec for the trailing (unstacked) dims; () means fully replicated."""
    M = MODEL_AXIS
    if key in ("wq", "wk", "wv", "wuk", "wuv"):
        return (None, M, None)          # (d|R, heads, head_dim): shard heads
    if key == "wo":
        return (M, None)                # (heads*hd, d): shard contracting dim
    if key in ("bq", "bk", "bv"):
        return (M, None)                # (heads, head_dim)
    if key == "wdkv":
        return (None, M)                # (d, kv_lora_rank): shard the latent
    if key == "wkr":
        return ()                       # shared rope key: small, replicated
    if key in ("wi", "wu", "wd") and "moe" in names and "shared" not in names:
        return (M, None, None)          # (E, ., .): expert parallelism
    if key in ("wi", "wu", "wz", "wx"):
        return (None, M)                # (d, ffn|d_inner): shard hidden dim
    if key in ("wd", "out_proj"):
        return (M, None)                # (ffn|d_inner, d): shard hidden dim
    if key == "embed":
        return (M, None)                # (vocab, d): shard vocab
    if key == "head":
        return (None, M)                # (d, vocab): shard vocab
    if key == "w":
        # vision: 2-D fc sharded on out-features, 4-D conv kernels replicated
        return (None, M) if ndim == 2 else ()
    return ()   # norms, biases, router, conv, meta tokens, scalars


def param_spec(names, ndim: int) -> tuple:
    """The spec of one parameter leaf from its path names (dict keys and
    list positions, as strings), right-aligned to its rank. Not
    divisibility-checked: compose with :func:`sanitize_spec`."""
    names = [str(n) for n in names]
    key = names[-1] if names else ""
    base = list(_base_rule(names, key, ndim))
    if not base:
        return ()
    if len(base) > ndim:
        base = base[len(base) - ndim:]
    return tuple([None] * (ndim - len(base)) + base)


def fsdp_param_spec(names, shape, mesh) -> tuple:
    """``param_spec`` + the data axes on the largest dim not taken by
    ``model``, preferring dims they divide; the leaf stays as it was when
    that dim is smaller than the data extent and none divides."""
    ndim = len(shape)
    base = list(sanitize_spec(param_spec(names, ndim), shape, mesh))
    base += [None] * (ndim - len(base))
    dp = dp_axes_of(mesh)
    kdp = dp_size_of(mesh)
    cands = [i for i in range(ndim) if base[i] is None]
    if not cands:
        return tuple(base)
    div = [i for i in cands if shape[i] % kdp == 0]
    pick = max(div or cands, key=lambda i: shape[i])
    if shape[pick] < kdp and not div:
        return tuple(base)  # too small to shard
    base[pick] = dp if len(dp) > 1 else dp[0]
    return tuple(base)


def fsdp_dim(names, shape, k: int) -> int | None:
    """The dim of a leaf of ``shape`` (at path ``names``) that k ranks
    shard, or None when every rank holds it whole."""
    spec = fsdp_param_spec(names, tuple(shape), data_mesh(k))
    return spec.index("data") if "data" in spec else None
