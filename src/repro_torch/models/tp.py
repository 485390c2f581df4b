"""Tensor parallelism over the dry run's ``model`` axis (DTensor).

:func:`tp_model` wraps a :class:`~repro_torch.models.registry.Model` so
that its programs take one device's shards (plain tensors, as the data
axes hand them over) and run on DTensors of a one-dimensional
``DeviceMesh``: each leaf is wrapped with the placement of its spec
(``dist/sharding.py``; ``Shard(i)`` where the spec names ``model``,
else ``Replicate()``), the batch replicated, and every plain tensor the
model makes on the way (positions, masks) is taken as replicated (the
caller runs the program, its backward included, under DTensor's
``implicit_replication``). DTensor's sharding propagation then issues
the collectives of tensor parallelism: the all-reduce of a row-parallel
product's partial sums, the gathers a replicated op needs, and, through
``dist/act.py``, the reduce-scatter of the sequence-parallel residual.

Where DTensor's own rules do not fit, a function runs on each device's
shard the way ``torch.distributed.tensor.experimental.local_map`` runs
one (its inputs redistributed to the placement the reference gives
them, ``to_local``, the function, then the result as a DTensor):
attention per head (:func:`heads_local`; a head count the model axis
does not divide is replicated, as the reference's ``sanitize_spec``
would drop it), the SSM mixer per head (:func:`ssm_local`), the
vocab-parallel embedding (:func:`embedding`), expert-parallel MoE
(:func:`experts_local`) and the vocab-parallel loss
(:func:`vocab_parallel_nll`). A device's term of a sum over the axis
becomes a DTensor through :func:`partial_sum`, and what a device reads
whole but uses in part gets a partial gradient, so that the backward
is the tensor-parallel program's too (``tests/test_torch_model_axis.py``
holds both to plain tensors on 2 gloo ranks). Each site names its
collectives in a cost count (``roofline.analysis.collective_site``);
PERF.md lists what each costs.
Outside the dry run (no model mesh) :func:`tp_model` returns the model
as it is and the helpers are identities: a plain tensor never takes a
DTensor path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from repro_torch.dist.sharding import named_leaves, spec_leaves
from repro_torch.tree import flatten, leaves, unflatten


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "placements")


def _dt():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def _placement(spec):
    from repro_torch.dist.sharding import MODEL_AXIS, placements
    return placements(spec or (), (MODEL_AXIS,))


def wrap(x, mesh, spec=None):
    """A plain tensor as the DTensor of which it is rank 0's shard."""
    DTensor, _, _ = _dt()
    if not isinstance(x, torch.Tensor) or is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, _placement(spec), run_check=False)


def plain(x, full: bool = False):
    """A DTensor's local shard (``full``: the whole tensor, gathered or
    reduced as its placement needs); other values as they are."""
    if not is_dtensor(x):
        return x
    return x.full_tensor() if full else x.to_local()


def _relocated(names, spec) -> bool:
    """Whether ``spec`` (a sanitized parameter spec) has the model axis on
    another dim than the rule table's: ``sanitize_spec`` moved it (20 heads
    on 16 devices to the head dim), and the products that read the leaf
    would flatten a sharded dim that does not lead its group."""
    from repro_torch.dist.sharding import MODEL_AXIS, param_spec
    spec = tuple(spec or ())
    rule = param_spec(names, len(spec))
    return MODEL_AXIS in spec and (MODEL_AXIS not in rule or spec.index(
        MODEL_AXIS) != rule.index(MODEL_AXIS))


def wrap_param(x, mesh, names, spec, heads_divide: bool = True):
    """A parameter shard as its DTensor: gathered to replicated at use
    where its spec moved the model axis (:func:`_relocated`), and, for
    the out projection ``wo``, where the model axis does not divide the
    attention heads (``heads_divide`` False): its flat (heads x head_dim)
    rows are then sharded across a head, and the backward's split of
    that dim into heads has no sharding rule. It stays sharded at rest,
    as the reference keeps it."""
    w = wrap(x, mesh, spec)
    if is_dtensor(w) and len(spec or ()) == w.ndim and (
            _relocated(names, spec) or (not heads_divide and names
                                        and names[-1] == "wo")):
        return replicated(w, "parameter gathered at use")
    return w


def _heads_divide(model, mesh) -> bool:
    a = getattr(model.cfg, "attention", None)
    return a is None or a.num_heads % mesh.size() == 0


def _wrap_tree(tree, mesh, specs, params: bool = False,
               heads_divide: bool = True):
    ls, td = flatten(tree)
    sp = spec_leaves(specs) if specs is not None else [None] * len(ls)
    if params:
        names = [n for n, _ in named_leaves(tree)]
        return unflatten(td, [wrap_param(x, mesh, n, s, heads_divide)
                              for x, n, s in zip(ls, names, sp)])
    return unflatten(td, [wrap(x, mesh, s) for x, s in zip(ls, sp)])


def _map(fn, tree):
    ls, td = flatten(tree)
    return unflatten(td, [fn(x) for x in ls])


def _site(name):
    from repro_torch.roofline.analysis import collective_site
    return collective_site(name)


def replicated(x, site: str | None = None):
    """``x`` replicated on its mesh (a gather where it is sharded); a
    plain tensor as it is. ``site`` names the gather in a cost count
    (``roofline.analysis.collective_site``)."""
    if not is_dtensor(x):
        return x
    _, Replicate, _ = _dt()
    want = (Replicate(),) * len(x.placements)
    if tuple(x.placements) == want:
        return x
    with _site(site) if site else contextlib.nullcontext():
        return x.redistribute(x.device_mesh, want)


def column_input(x, w):
    """``x`` gathered whole where ``w``, the weight a product reads it
    with, is sharded on its output (last) dim and ``x`` is not
    replicated: the all-gather of a sequence-parallel activation before
    a column-parallel product. Left to DTensor, that product gathers the
    weight instead and yields full-width partial sums, which the
    nonlinearity after it must reduce: every device would then compute
    the layer whole. Other inputs as they are."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    _, _, Shard = _dt()
    if tuple(w.placements) != (Shard(w.ndim - 1),):
        return x
    return replicated(x, "sequence-parallel gather")


@functools.lru_cache(maxsize=None)
def _partial_cls():

    class PartialSum(torch.autograd.Function):
        """A device's local term of a sum over the model axis as the
        ``Partial`` DTensor of the sum; the backward hands each term the
        sum's gradient whole (``DTensor.from_local``'s backward would
        divide it by the axis size, which the terms of a sum do not)."""

        @staticmethod
        def forward(ctx, x, mesh):
            DTensor, _, _ = _dt()
            from torch.distributed.tensor import Partial
            return DTensor.from_local(x.view_as(x), mesh, (Partial(),),
                                      run_check=False)

        @staticmethod
        def backward(ctx, g):
            return replicated(g).to_local(), None
    return PartialSum


def partial_sum(x, mesh):
    """The sum over ``mesh``'s devices of each one's ``x`` (a plain
    tensor), as a ``Partial`` DTensor (reduced where it is read)."""
    return _partial_cls().apply(x, mesh)


def tp_model(model, mesh, param_specs, cache_specs=None):
    """``model`` whose ``loss_fn``, ``forward`` and ``decode_step`` take
    rank 0's shards and run on DTensors of ``mesh`` (module docstring);
    ``param_specs``: a spec a parameter leaf (None: all replicated, the
    BSP placement); ``cache_specs`` likewise for the decode cache.
    ``model`` itself when ``mesh`` is None."""
    if mesh is None:
        return model
    hd = _heads_divide(model, mesh)

    def batch_of(batch):
        return {k: wrap(v, mesh) for k, v in batch.items()}

    def loss_fn(params, batch, gen=None, gather=None):
        if gather is None:
            loss, metrics = model.loss_fn(
                _wrap_tree(params, mesh, param_specs, True, hd),
                batch_of(batch), gen)
        else:
            named = list(named_leaves(params))
            sp = (spec_leaves(param_specs) if param_specs is not None
                  else [None] * len(named))
            spec_of = {id(x): (n, s) for (n, x), s in zip(named, sp)}

            def gather_tp(tree):
                xs, td = flatten(tree)
                ys = leaves(gather(tree))
                return unflatten(td, [wrap_param(y, mesh, *spec_of[id(x)],
                                                 hd)
                                      for x, y in zip(xs, ys)])
            loss, metrics = model.loss_fn(params, batch_of(batch), gen,
                                          gather=gather_tp)
        return plain(loss, True), {k: plain(v, True)
                                   for k, v in metrics.items()}

    def forward(params, batch):
        return plain(model.forward(_wrap_tree(params, mesh, param_specs,
                                              True, hd), batch_of(batch)))

    def decode_step(params, cache, batch, pos, seq_len, **kw):
        logits, new_cache = model.decode_step(
            _wrap_tree(params, mesh, param_specs, True, hd),
            _wrap_tree(cache, mesh, cache_specs), batch_of(batch), pos,
            seq_len, **kw)
        return plain(logits), _map(plain, new_cache)

    return dataclasses.replace(model, loss_fn=loss_fn, forward=forward,
                               decode_step=decode_step)


def heads_local(fn):
    """``fn`` (attention: q (B, S, H, D), k and v (B, S, KV, D), keyword
    options) run per head on each device's shard when its inputs are
    DTensors. A q that is not replicated (heads sharded by its
    projection's placement, the reference's rule, or a partial sum of a
    sequence-parallel input) has its heads sharded when they divide the
    model axis and each device's query heads read whole KV heads; it is
    replicated otherwise, and a replicated q stays so (a program with
    nothing on the model axis runs whole, as the reference's does). k and
    v have their heads sharded when q's are and the KV heads divide, else
    they are replicated and cut to the KV heads that this device's query
    heads read. The output has q's placement. Plain tensors call
    ``fn``."""
    @functools.wraps(fn)
    def wrapped(q, k, v, *args, **kw):
        if not is_dtensor(q):
            return fn(q, k, v, *args, **kw)
        DTensor, Replicate, Shard = _dt()
        from torch.distributed.tensor import Partial
        mesh = q.device_mesh
        n, r = mesh.size(), mesh.get_local_rank()
        H, KV = q.shape[2], k.shape[2]
        G, Hl = H // KV, H // n
        heads, whole = (Shard(2),), (Replicate(),)
        qs = heads if tuple(q.placements) != whole and H % n == 0 and (
            KV % n == 0 or G % Hl == 0) else whole
        kvs = heads if qs == heads and KV % n == 0 else whole
        site = ("attention, heads replicated" if qs != heads else
                "attention, KV heads replicated" if kvs != heads else
                "attention, heads sharded")
        with _site(site):
            q, k, v = (q.redistribute(mesh, qs), k.redistribute(mesh, kvs),
                       v.redistribute(mesh, kvs))
        ql = q.to_local()
        # a replicated K/V that each device reads for its own query heads
        # alone gets a partial gradient, summed over the model axis
        part = (Partial(),) if qs == heads and kvs != heads else None
        kl, vl = (k.to_local(grad_placements=part),
                  v.to_local(grad_placements=part))
        if qs == heads and kvs != heads:
            # query heads [r Hl, (r + 1) Hl) read KV heads
            # [r Hl // G, ceil((r + 1) Hl / G))
            k0, k1 = r * Hl // G, -(-(r + 1) * Hl // G)
            kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
        out = fn(ql, kl.contiguous(), vl.contiguous(), *args, **kw)
        if isinstance(out, tuple):
            return tuple(DTensor.from_local(o, mesh, qs, run_check=False)
                         for o in out)
        return DTensor.from_local(out, mesh, qs, run_check=False)
    return wrapped


def embedding(tokens, table):
    """``F.embedding(tokens, table)``; for a vocab-sharded table (a
    DTensor, ``Shard(0)``) each device looks up the ids its rows hold,
    zeros the others, and the partial sums are all-reduced (DTensor's own
    rule for this gives a masked partial that a backward through a
    second redistribution cannot take)."""
    if not (is_dtensor(table) and any(
            getattr(p, "dim", None) == 0 for p in table.placements)):
        out = torch.nn.functional.embedding(tokens, table)
        return replicated(out)
    DTensor, Replicate, _ = _dt()
    from torch.distributed.tensor import Partial
    mesh = table.device_mesh
    local = table.to_local()
    rows = local.shape[0]
    lo = rows * mesh.get_local_rank()
    ids = replicated(tokens).to_local().long() - lo
    keep = (ids >= 0) & (ids < rows)
    out = torch.nn.functional.embedding(ids.clamp(0, rows - 1), local)
    out = out * keep[..., None].to(out.dtype)
    return replicated(partial_sum(out, mesh), "embedding, partial sums")


def experts_local(moe_fn, shared_fn):
    """``moe_fn(p, x, m, **kw) -> (y, aux)`` (``models/moe.py``) on
    DTensors as expert parallelism, the reference's placement of the
    expert weights (the expert dim over the model axis): each device
    routes the whole (replicated) tokens, computes the experts it holds
    (``expert_lo``) on its shard, and the partial sums over experts are
    all-reduced; the shared expert (``shared_fn(p["shared"], x)``) runs
    as a tensor-parallel MLP beside it. DTensor's own rules for the
    routing's index ops shard the flattened tokens, which a batch the
    model axis does not divide cannot take back. Plain tensors call
    ``moe_fn``."""
    @functools.wraps(moe_fn)
    def wrapped(p, x, m, **kw):
        if not is_dtensor(x):
            return moe_fn(p, x, m, **kw)
        with _site("MoE, experts sharded"):
            return local(p, x, m, **kw)

    def local(p, x, m, **kw):
        DTensor, Replicate, Shard = _dt()
        from torch.distributed.tensor import Partial
        mesh = x.device_mesh
        experts = {n: v for n, v in p.items() if n != "shared"}
        sharded = tuple(experts["wi"].placements) == (Shard(0),)
        # with the experts sharded, what each device reads whole but
        # uses for its experts alone gets a partial gradient
        part = (Partial(),) if sharded else None
        local = {n: (v.to_local() if sharded and n in ("wi", "wu", "wd")
                     else replicated(v).to_local(grad_placements=part))
                 for n, v in experts.items()}
        lo = local["wi"].shape[0] * mesh.get_local_rank() if sharded else 0
        kw = {n: (replicated(v).to_local() if is_dtensor(v) else v)
              for n, v in kw.items()}
        y, aux = moe_fn(local, replicated(x).to_local(grad_placements=part),
                        m, expert_lo=lo, **kw)
        if sharded:
            # every device computes the whole routing's aux loss: its
            # share 1/n of it, so that the router's gradient sums whole
            y, aux = partial_sum(y, mesh), partial_sum(aux / mesh.size(),
                                                       mesh)
        else:
            y, aux = (DTensor.from_local(t, mesh, (Replicate(),),
                                         run_check=False) for t in (y, aux))
        if "shared" in p:
            y = y + shared_fn(p["shared"], x)
        return y, aux
    return wrapped


def _take(t, dim: int, lo: int, hi: int):
    """Rows ``[lo, hi)`` of ``t``'s dim ``dim`` on this device: its local
    shard where ``t`` is sharded on that dim (rank 0's rows), else a
    view of the replicated whole."""
    _, _, Shard = _dt()
    from torch.distributed.tensor import Partial
    if is_dtensor(t) and tuple(t.placements) == (Shard(dim),):
        return t.to_local()
    # each device reads its rows alone: a partial gradient of the whole
    return replicated(t).to_local(grad_placements=(Partial(),)).narrow(
        dim, lo, hi - lo)


def _channels(full, di: int, lo: int, hi: int):
    """The conv channels ``[lo, hi)`` of the x part (the first ``di`` of
    the last dim) and every B/C channel after them."""
    return torch.cat([full[..., lo:hi], full[..., di:]], dim=-1)


def ssm_local(fn, with_cache: bool = False):
    """``fn``, ``ssm_forward(p, x, d_model, s, eps)`` or, with
    ``with_cache``, ``ssm_decode(p, cache, x, d_model, s, eps)``
    (``models/ssm.py``), run on each device's shard when ``x`` is a
    DTensor, with the reference's placement of the mixer (``wz``/``wx``
    column- and ``out_proj`` row-parallel over the SSM heads):

    - the heads and the width divide the model axis and the B/C groups
      are one: each device runs its heads (its ``wz``/``wx``/
      ``out_proj`` shards, or its rows of them where BSP replicates
      them, its slice of the per-head and conv leaves, the whole
      ``wbc``) on the gathered input, the gated norm's mean square
      all-reduced over the heads; the output is a partial sum over
      them, and a leaf read whole or in part gets a partial gradient;
      the decode cache's state is its heads' shard;
    - otherwise (hymba's 50 heads on 16) every device runs the whole
      mixer on replicated inputs, as the reference's ``sanitize_spec``
      drops a sharding that does not divide; a cache leaf sharded on
      another dim is gathered for the step and its shard written back.

    DTensor's own rules take neither the scan's cumulative sums (their
    backward flips) nor a product's flattening of a sharded heads dim on
    every PyTorch release. Plain tensors call ``fn``."""
    @functools.wraps(fn)
    def wrapped(p, *args, **kw):
        cache, rest = (args[0], args[1:]) if with_cache else (None, args)
        x, d_model, s = rest[:3]
        if not is_dtensor(x):
            return fn(p, *args, **kw)
        n = x.device_mesh.size()
        heads = (s.expand * d_model // s.head_dim) % n == 0 and \
            d_model % n == 0 and s.ngroups == 1
        with _site("SSM mixer, heads sharded" if heads else
                   "SSM mixer, whole on every device"):
            return local(heads, p, cache, rest, kw)

    def local(heads, p, cache, rest, kw):
        x, d_model, s = rest[:3]
        DTensor, Replicate, Shard = _dt()
        from torch.distributed.tensor import Partial
        mesh = x.device_mesh
        n, r = mesh.size(), mesh.get_local_rank()
        di = s.expand * d_model
        nh = di // s.head_dim
        if heads:
            # what each device reads whole but uses for its heads alone
            # gets a partial gradient, summed over the model axis
            part = (Partial(),)
            xl = replicated(x).to_local(grad_placements=part)
            lo, hi = r * nh // n, (r + 1) * nh // n
            dlo, dhi = r * di // n, (r + 1) * di // n
            cols = ("wz", "wx", "out_proj")
            lp = {k: replicated(v).to_local(grad_placements=part)
                  for k, v in p.items() if k not in cols}
            lp.update(wz=_take(p["wz"], 1, dlo, dhi),
                      wx=_take(p["wx"], 1, dlo, dhi),
                      out_proj=_take(p["out_proj"], 0, dlo, dhi),
                      wdt=lp["wdt"][:, lo:hi], A_log=lp["A_log"][lo:hi],
                      dt_bias=lp["dt_bias"][lo:hi], D=lp["D"][lo:hi],
                      norm=lp["norm"][dlo:dhi],
                      conv_w=_channels(lp["conv_w"], di, dlo, dhi),
                      conv_b=_channels(lp["conv_b"], di, dlo, dhi))

            def norm_reduce(ms):            # local heads' mean -> all
                return replicated(partial_sum(ms / n, mesh)).to_local(
                    grad_placements=part)
            kw["norm_reduce"] = norm_reduce
            args_l = (d_model // n, s) + tuple(rest[3:])
            if with_cache:
                conv = replicated(cache["conv"]).to_local()
                lc = {"conv": _channels(conv, di, dlo, dhi),
                      "state": _take(cache["state"], 1, lo, hi)}
                out = fn(lp, lc, xl, *args_l, **kw)[0]
                # the replicated window stays whole: its x channels are
                # gathered from the heads' devices, its B/C ones are alike
                conv[..., :di].copy_(DTensor.from_local(
                    lc["conv"][..., :dhi - dlo], mesh, (Shard(2),),
                    run_check=False).full_tensor())
                conv[..., di:].copy_(lc["conv"][..., dhi - dlo:])
            else:
                out = fn(lp, xl, *args_l, **kw)
            out = partial_sum(out, mesh)
        else:
            xl = replicated(x).to_local()
            lp = {k: replicated(v).to_local() for k, v in p.items()}
            if with_cache:
                lc = {k: replicated(v).to_local() for k, v in cache.items()}
                out = fn(lp, lc, xl, *rest[1:], **kw)[0]
                for k, v in cache.items():
                    sh = [pl for pl in v.placements if isinstance(pl, Shard)]
                    if sh:
                        d = sh[0].dim
                        m = v.to_local().shape[d]
                        v.to_local().copy_(lc[k].narrow(d, r * m, m))
            else:
                out = fn(lp, xl, *rest[1:], **kw)
            out = DTensor.from_local(out, mesh, (Replicate(),),
                                     run_check=False)
        return (out, cache) if with_cache else out
    return wrapped


def vocab_parallel_nll(logits, labels):
    """The per-position cross-entropy ``logsumexp(logits) -
    logits[label]`` in fp32 of logits on the model axis, without
    gathering them: sharded on the vocab (last) dim (a partial sum is
    reduce-scattered to it), each device's max, sum of exponentials and
    label logit over its vocab rows, combined by all-reduces of
    per-position scalars (the vocab-parallel cross-entropy of
    tensor-parallel training), as a replicated DTensor. None for a plain
    tensor, replicated logits, or a vocab the axis does not divide."""
    if not is_dtensor(logits):
        return None
    DTensor, Replicate, Shard = _dt()
    from torch.distributed.tensor import Partial
    mesh = logits.device_mesh
    if tuple(logits.placements) == (Replicate(),) or \
            logits.shape[-1] % mesh.size():
        return None
    with _site("loss, vocab-parallel"):
        x = logits.redistribute(mesh, (Shard(logits.ndim - 1),)).to_local(
        ).float()
        rows = x.shape[-1]
        lo = rows * mesh.get_local_rank()
        top = DTensor.from_local(x.detach().amax(-1), mesh,
                                 (Partial("max"),),
                                 run_check=False).full_tensor()
        total = replicated(partial_sum(torch.exp(x - top[..., None]).sum(-1),
                                       mesh)).to_local()
        ids = replicated(labels).to_local().long() - lo
        keep = (ids >= 0) & (ids < rows)
        pick = torch.gather(x, -1, ids.clamp(0, rows - 1)[..., None])[..., 0]
        ll = replicated(partial_sum(pick * keep.to(pick.dtype),
                                    mesh)).to_local()
    return DTensor.from_local(torch.log(total) + top - ll, mesh,
                              (Replicate(),), run_check=False)
