"""Placement rules (counterpart of ``repro/dist/sharding.py``).

The reference places every leaf on a ``(pod, data, model)`` mesh with a
``PartitionSpec``. A spec here is a tuple of entries, one a dim: an axis
name, a tuple of names, or None. :class:`Mesh` carries what the rules
read of a ``jax.sharding.Mesh``: the axis names in mesh order and their
sizes. The training ranks form the data axes alone (``data``, or
``pod`` x ``data``); the ``model`` axis exists in the dry run
(``launch/dryrun.py``), which places the model-axis entries on a
``DeviceMesh`` as DTensor placements (:func:`placements`).

- :func:`param_spec` is the reference's rule table (tensor parallelism
  over ``model``: heads, the FFN hidden dim, experts, the vocab), with its
  ``set_replicate_attn`` ablation;
- :func:`sanitize_spec` repairs a spec for a shape: an axis that is not
  on the mesh drops (so on the port's pure-data meshes every ``model``
  entry does), one that does not divide its dim moves to the nearest
  free dim it divides, or drops;
- :func:`fsdp_param_spec` adds the data axes on the largest free dim
  (preferring dims they divide), the reference's FSDP rule;
  :func:`fsdp_dim` is the dim it picks for a leaf on k ranks, or None
  when the leaf stays whole;
- the tree builders :func:`param_shardings`, :func:`state_shardings`,
  :func:`batch_shardings`, :func:`cache_shardings` and
  :func:`fsdp_state_shardings` (the reference's ``core/gspmd.py``
  one) give a spec for every leaf of a tree, and :func:`local_shape`
  one device's shape of a leaf under its spec.

The port holds a decoder's layers one dict a layer where the reference
stacks them; the rules read the leaf as it is held, so a stacked leaf's
leading layer dim, which the reference's FSDP rule may shard, has no
counterpart here (``launch/dryrun.py`` says what that moves).
"""
from __future__ import annotations

from dataclasses import dataclass

MODEL_AXIS = "model"

# attention/SSM mixer leaves affected by set_replicate_attn
_ATTN_KEYS = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv",
                        "wuk", "wuv", "wdkv", "wkr"})
_SSM_KEYS = frozenset({"wz", "wx", "wbc", "wdt", "out_proj",
                       "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm"})

_REPLICATE_ATTN = False


def set_replicate_attn(flag: bool) -> None:
    """Globally replicate attention/SSM mixer params (no TP on them)."""
    global _REPLICATE_ATTN
    _REPLICATE_ATTN = bool(flag)


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


def _dp_entry(mesh):
    """The spec entry sharding one dim over all data axes (None if pure
    TP)."""
    dp = dp_axes_of(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


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
    if _REPLICATE_ATTN and (key in _ATTN_KEYS or key in _SSM_KEYS):
        return ()
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


# ---------------------------------------------------------------------------
# tree builders (a spec for every leaf)
# ---------------------------------------------------------------------------

def named_leaves(tree, names=()):
    """(path names, leaf) in ``tree.flatten``'s order (sorted dict keys,
    list positions as strings)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key], names + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, names + (str(i),))
    else:
        yield names, tree


def map_named(fn, tree, names=()):
    """``tree`` with each leaf replaced by ``fn(path names, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_named(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(names, tree)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in its tree's leaf order (sorted dict
    keys, list positions): a spec is a tuple, so it is a leaf here where
    ``tree.flatten`` would open it."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_shardings(mesh, params):
    """Model-sharded, data-replicated specs of a parameter tree."""
    return map_named(lambda names, leaf: sanitize_spec(
        param_spec(names, len(_shape(leaf))), _shape(leaf), mesh), params)


def state_shardings(mesh, state):
    """BSP train-state specs: every leaf replicated over the whole mesh,
    the paper's replicated data parallelism (the exchangers own the data
    axes; the model axis acts through the activation constraints)."""
    return map_named(lambda names, leaf: (), state)


def batch_shardings(mesh, batch):
    """Batch leaves sharded over the data (+pod) axes on dim 0."""
    dpe = _dp_entry(mesh)
    return map_named(lambda names, leaf: sanitize_spec(
        (dpe,) if dpe is not None else (), _shape(leaf), mesh), batch)


def cache_shardings(mesh, cache, global_batch: int,
                    page_batch: int | None = None):
    """Decode-cache specs: the batch dim (or a paged pool's page dim,
    ``page_batch``) over the data axes, head-like dims over ``model``
    (KV heads of k/v, MLA's latent ``ckv``, SSM heads of ``state``); conv
    windows and rope keys replicated."""
    dpe = _dp_entry(mesh)

    def leaf(names, t):
        key = names[-1] if names else ""
        shape = _shape(t)
        entries = [None] * len(shape)
        if dpe is not None:
            for i, s in enumerate(shape):
                if s == global_batch or (page_batch is not None
                                         and s == page_batch):
                    entries[i] = dpe
                    break
        if not _REPLICATE_ATTN:
            mi = None
            if key in ("k", "v") and len(shape) >= 2:
                mi = len(shape) - 2          # (..., S, KV, hd): KV heads
            elif key == "ckv":
                mi = len(shape) - 1          # (..., S, R): MLA latent
            elif key == "state" and len(shape) >= 3:
                mi = len(shape) - 3          # (..., nh, N, P): SSM heads
            if mi is not None and entries[mi] is None:
                entries[mi] = MODEL_AXIS
        return sanitize_spec(tuple(entries), shape, mesh)

    return map_named(leaf, cache)


def fsdp_state_shardings(mesh, state):
    """GSPMD/FSDP train-state specs (the reference's
    ``core/gspmd.py:fsdp_state_shardings``): the parameters and the
    optimizer's ``m``/``v`` by :func:`fsdp_param_spec`, every other entry
    replicated."""
    fsdp = lambda tree: map_named(  # noqa: E731
        lambda names, leaf: fsdp_param_spec(names, _shape(leaf), mesh), tree)
    opt = {k: (fsdp(v) if k in ("m", "v") else map_named(
        lambda names, leaf: (), v)) for k, v in state["opt"].items()}
    return {"params": fsdp(state["params"]), "opt": opt, "step": ()}


def local_shape(shape, spec, mesh) -> tuple:
    """One device's shape of a leaf of ``shape`` placed by ``spec`` (a
    sanitized spec: each entry's extent divides its dim)."""
    out = list(shape)
    for i, e in enumerate(spec):
        if e is not None:
            out[i] //= _extent(mesh, e)
    return tuple(out)


def placements(spec, mesh_dims) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh`` whose dims are
    named ``mesh_dims``: ``Shard(i)`` on the mesh dim that dim i's entry
    names, ``Replicate()`` on a mesh dim that no entry names."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for dim in mesh_dims:
        hit = [i for i, e in enumerate(spec) if e == dim or (
            isinstance(e, (tuple, list)) and dim in e)]
        out.append(Shard(hit[0]) if hit else Replicate())
    return tuple(out)
