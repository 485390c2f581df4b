"""Parameter-exchange strategies on ``torch.distributed`` — the paper's
core contribution (§3.2), counterpart of ``repro/core/exchanger.py``.

Each rank is one process of a process group; the exchanger mean-reduces
a gradient (or parameter) tree across the group:

- ``ar``      : MPI_Allreduce analogue -> ``all_reduce`` (halves:
                ``reduce_scatter_tensor`` / ``all_gather``)
- ``asa``     : Alltoall-sum-Allgather (Fig 2) -> ``all_to_all_single`` +
                a local fp32 sum of the k received chunks (the
                ``chunk_sum`` kernel) + ``all_gather``
- ``asa16``   : ASA with an fp16 wire (the ``quant_fp16`` /
                ``dequant_fp16`` kernels), fp32 sum
- ``asabf16`` : ASA with a bf16 wire (a plain cast, as in the JAX package)
- ``asa8``    : int8 wire, one absmax scale per rank chunk
- ``ring``    : ring reduce-scatter and all-gather, k - 1 hops each to
                the next rank (``Transport.send_recv``)
- ``ring16``  : the ring with an fp16 wire, rounded at every hop
- ``none``    : identity

- ``hier``    : ``asa`` over a two-level pod x data topology: the
                all-to-all and the fp32 sum inside a pod, an fp32
                all-reduce of the 1/k shard across pods, the all-gather
                inside the pod
- ``hier16``  : the same with an fp16 wire inside the pod

As in the JAX package, the topology belongs to the transport, not to the
strategy: a :class:`Transport` with a ``lead`` transport (built by
:func:`make_transport` for ``data_axes=("pod", "data")``) runs every
strategy in two levels. Its ``k`` and ``rank`` are those of the
intra-pod (reduce-scatter) axis, so plans, shards and the sharded update
are per pod; small leaves and metrics are all-reduced over every rank.
Across pods an int8 wire falls back to fp16 and ``ring`` stages like
``asa``, as in the reference; the raw (fused) reduce-scatter is
single-level only.

Every strategy splits into a ``reduce_scatter`` half (each rank keeps
the fp32 mean of its 1/k shard of every bucket) and an ``all_gather``
half, and ``exchange`` is their composition (``ar`` keeps one fused
``all_reduce``). ``reduce_scatter(raw=True)`` hands the un-summed (k, s)
receives to the ``fused_rs_update`` kernel instead. Leaves are packed
into flat fp32 buckets (``make_rs_plan``) in the JAX package's leaf
order (sorted dict keys), so plans, shards and weight-decay masks equal
the reference's; leaves of at most ``_SMALL_LEAF`` elements are
all-reduced whole.

The collectives run through a :class:`Transport` on one process group,
so the same code runs on gloo and on NCCL. gloo carries every collective
through host memory, copying a CUDA tensor there and back itself; the
transport makes that copy explicit, into pinned host buffers it keeps
per shape, so a run can time and count the staging apart from the
collective. That is the wire, not a fallback: every sum, cast and update
stays on the card. NCCL (one card per rank) takes the CUDA tensors
directly.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from math import prod
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.kernels.chunk_sum import chunk_sum
from repro_torch.kernels.quantize import dequant_fp16, quant_fp16
from repro_torch.tree import flatten, unflatten

# leaves smaller than this are all-reduced whole (chunking overhead dominates)
_SMALL_LEAF = 1024
# how often the all-to-all helper thread polls a device -> host copy
_POLL_S = 5e-5


# ---------------------------------------------------------------------------
# the transport: one process group's collectives
# ---------------------------------------------------------------------------

_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class Transport:
    """Collectives over ``group`` (None: the default group; with no
    process group initialised, a group of one in which every collective
    is the identity).

    ``lead`` (a Transport over the ranks at this rank's position in every
    pod, or None) makes it two-level: ``k`` and ``rank`` stay the
    intra-pod ones, ``world_k``/``world_rank`` count every rank, and
    :meth:`all_reduce` sums over both levels.

    On a gloo group a CUDA tensor goes through pinned host buffers, kept
    per shape so a step reuses them; ``stage_s`` and ``wire_s`` add up
    the host time of those copies and of the collectives, and
    ``staged_bytes`` what the copies moved, so a run can say how much of
    its exchange is staging. ``exposed_s`` is the host time spent waiting
    for an all-to-all started by :meth:`all_to_all_start`."""

    def __init__(self, group=None, lead: Transport | None = None):
        self.group = group
        self.lead = lead
        if dist.is_available() and dist.is_initialized():
            self.k = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
        else:
            self.k, self.rank, self.backend = 1, 0, "local"
        self._pinned: dict = {}
        self.staged_bytes = 0
        self.stage_s = 0.0
        self.wire_s = 0.0
        self.exposed_s = 0.0

    @property
    def world_k(self) -> int:
        return self.k * (self.lead.k if self.lead else 1)

    @property
    def world_rank(self) -> int:
        return (self.lead.rank * self.k if self.lead else 0) + self.rank

    def counters(self) -> tuple:
        """(staged_bytes, stage_s, wire_s, exposed_s) of both levels."""
        own = (self.staged_bytes, self.stage_s, self.wire_s, self.exposed_s)
        if self.lead is None:
            return own
        return tuple(a + b for a, b in zip(own, self.lead.counters()))

    def _staged(self, x) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def _buf(self, role: str, shape, dtype) -> torch.Tensor:
        key = (role, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _run(self, op, x, out_shape):
        """``op(out, inp)`` on ``x``'s device, or staged through the host."""
        x = x.contiguous()
        if self.k == 1:
            return x.clone().reshape(out_shape)
        if not self._staged(x):
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            t0 = time.perf_counter()
            op(out, x)
            self.wire_s += time.perf_counter() - t0
            return out
        h_in = self._buf("in", x.shape, x.dtype)
        # wait for the work that produces x first, so that the staging time
        # below is the copies' own
        torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        h_in.copy_(x)                      # synchronous device -> host
        h_out = self._buf("out", out_shape, x.dtype)
        t1 = time.perf_counter()
        op(h_out, h_in)
        t2 = time.perf_counter()
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        out.copy_(h_out)                   # host -> device, waits for it
        self.stage_s += (t1 - t0) + (time.perf_counter() - t2)
        self.wire_s += t2 - t1
        self.staged_bytes += (x.numel() + prod(out_shape)) * x.element_size()
        return out

    def all_to_all(self, x):
        """(k, ...) -> (k, ...): row r goes to rank r; row r of the result
        came from rank r."""
        return self._run(lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), x, x.shape)

    def all_gather(self, x):
        """(s,) -> (k * s,) in rank order."""
        return self._run(lambda o, i: _all_gather(o, i, group=self.group),
                         x, (self.k * x.shape[0],) + tuple(x.shape[1:]))

    def reduce_scatter(self, x):
        """(k * s,) -> (s,): this rank's shard of the sum."""
        return self._run(lambda o, i: dist.reduce_scatter_tensor(
            o, i, op=dist.ReduceOp.SUM, group=self.group), x,
            (x.shape[0] // self.k,) + tuple(x.shape[1:]))

    def all_reduce(self, x):
        """Sum over the group, and across pods when two-level (a new
        tensor)."""
        def op(o, i):
            o.copy_(i)
            dist.all_reduce(o, op=dist.ReduceOp.SUM, group=self.group)
        out = self._run(op, x, x.shape)
        return out if self.lead is None else self.lead.all_reduce(out)

    def broadcast(self, x, src: int):
        """``x`` of group rank ``src`` on every rank (a new tensor; the
        other ranks pass a tensor of the same shape and dtype)."""
        def op(o, i):
            o.copy_(i)
            dist.broadcast(o, self._global(src), group=self.group)
        return self._run(op, x, x.shape)

    def all_to_all_start(self, xs) -> PendingAllToAll:
        """:meth:`all_to_all` of each (k, ...) tensor that the iterable
        ``xs`` yields, started and not waited for: ``.wait()`` on the
        result returns the received tensors. No other collective may be
        issued on this group before that ``.wait()``. See
        :class:`PendingAllToAll`."""
        return PendingAllToAll(self, xs)

    def _global(self, rank: int) -> int:
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def send_recv(self, x):
        """One ring hop: send ``x`` to rank + 1 and return what rank - 1
        sent (same shape and dtype)."""
        nxt = self._global((self.rank + 1) % self.k)
        prv = self._global((self.rank - 1) % self.k)

        def op(o, i):
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, i, nxt, self.group),
                    dist.P2POp(dist.irecv, o, prv, self.group)]):
                req.wait()
        return self._run(op, x, x.shape)


class PendingAllToAll:
    """All-to-alls in flight (:meth:`Transport.all_to_all_start`).

    On a gloo group a CUDA tensor is copied into a pinned buffer on the
    current stream without blocking, and a helper thread waits for that
    copy's event alone before it issues the ``async_op`` collective and
    waits on its ``Work``; the caller goes on queueing work (the next
    microbatch's forward and backward) meanwhile. ``wait()`` joins the
    thread, then queues the host -> device copies. Other groups and
    tensors issue ``async_op`` collectives directly.

    Each tensor of a call has pinned buffers of its own (keyed by its
    position), which the next call reuses. That is safe: an earlier
    call's host -> device copies were queued before this call's
    device -> host copies, whose events the helper waits for before any
    collective writes a buffer."""

    def __init__(self, tr: Transport, xs):
        self.tr = tr
        self.outs: list = []
        self.works: list = []
        self._thread = None
        self._error = None
        self._t0 = time.perf_counter()
        # staged: only each tensor's (shape, dtype, device) is kept, so
        # the caller's device tensor can go as soon as its copy is queued
        self._like: list = []
        self._h_out: list = []
        events, h_ins, keep = [], [], []
        for j, x in enumerate(xs):
            x = x.contiguous()
            if tr.k == 1:
                self.outs.append(x.clone())
            elif not tr._staged(x):
                out = torch.empty_like(x)
                self.outs.append(out)
                keep.append(x)
                self.works.append(dist.all_to_all_single(
                    out, x, group=tr.group, async_op=True))
            else:
                h_in = tr._buf(("a2a_in", j), x.shape, x.dtype)
                h_in.copy_(x, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                h_ins.append(h_in)
                events.append(ev)
                self._h_out.append(tr._buf(("a2a_out", j), x.shape,
                                           x.dtype))
                self._like.append((x.shape, x.dtype, x.device))
                tr.staged_bytes += 2 * x.numel() * x.element_size()
        self._keep = keep      # async_op inputs live until the wait
        if events:
            self._thread = threading.Thread(
                target=self._send, args=(events, h_ins), daemon=True)
            self._thread.start()

    def _send(self, events, h_ins) -> None:
        try:
            works, t0 = [], None
            for ev, h_in, h_out in zip(events, h_ins, self._h_out):
                while not ev.query():        # sleeps hold no lock
                    time.sleep(_POLL_S)
                if t0 is None:
                    t0 = time.perf_counter()
                works.append(dist.all_to_all_single(
                    h_out, h_in, group=self.tr.group, async_op=True))
            for w in works:
                w.wait()
            if t0 is not None:
                self.tr.wire_s += time.perf_counter() - t0
        except Exception as e:   # noqa: BLE001 — raised again by wait()
            self._error = e

    def wait(self) -> list:
        tr = self.tr
        t0 = time.perf_counter()
        if self._thread is None:
            for w in self.works:
                w.wait()
            if self.works:
                t1 = time.perf_counter()
                tr.exposed_s += t1 - t0
                tr.wire_s += t1 - self._t0
            return self.outs
        self._thread.join()
        t1 = time.perf_counter()
        tr.exposed_s += t1 - t0
        if self._error is not None:
            raise self._error
        outs = []
        for (shape, dtype, device), h_out in zip(self._like, self._h_out):
            out = torch.empty(shape, dtype=dtype, device=device)
            out.copy_(h_out, non_blocking=True)
            outs.append(out)
        tr.stage_s += time.perf_counter() - t1
        return outs


def make_transport(data_axes=("data",), pods: int = 1, group=None):
    """The transport of a plan's ``data_axes``: one level over ``group``
    for ``("data",)``; for two axes (``("pod", "data")``) the world's
    ranks split into ``pods`` pods of consecutive ranks, each rank in a
    pod group and in the lead group of the ranks at its position in every
    pod (the reference's ``_split_axes``: the reduce-scatter and
    all-gather over the last axis, an all-reduce over the first). Every
    rank of the world must call this, in the same order: it makes all
    groups. A Transport passed as ``group`` is returned as it is."""
    if isinstance(group, Transport):
        return group
    axes = tuple(data_axes)
    if len(axes) == 1:
        if pods != 1:
            raise ValueError(f"pods={pods} needs two data axes "
                             f"(data_axes=('pod', 'data')), got {axes}")
        return Transport(group)
    if len(axes) != 2:
        raise ValueError(f"data_axes has one or two levels, got {axes}")
    if group is not None:
        raise ValueError("a two-level transport spans the default group")
    if not (dist.is_available() and dist.is_initialized()):
        if pods != 1:
            raise ValueError(f"pods={pods} with no process group")
        return Transport()
    world = dist.get_world_size()
    if pods < 1 or world % pods:
        raise ValueError(f"{world} ranks do not split into {pods} pods")
    per = world // pods
    me = dist.get_rank()
    mine = lead = None
    for p in range(pods):
        g = dist.new_group([p * per + j for j in range(per)])
        if me // per == p:
            mine = g
    for j in range(per):
        g = dist.new_group([p * per + j for p in range(pods)])
        if me % per == j:
            lead = g
    return Transport(mine, Transport(lead) if pods > 1 else None)


def as_transport(group_or_transport) -> Transport:
    if isinstance(group_or_transport, Transport):
        return group_or_transport
    return Transport(group_or_transport)


# ---------------------------------------------------------------------------
# bucket plan: the static layout shared by RS, update, and AG
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BucketSpec:
    """One flat fp32 bucket: which leaves it packs and its padded extent."""
    leaves: tuple[int, ...]      # leaf indices (flatten order)
    sizes: tuple[int, ...]       # flat element counts, same order
    shard_len: int               # per-rank shard extent
    padded: int                  # k * shard_len


@dataclass(frozen=True)
class RSPlan:
    """Static reduce-scatter plan for one parameter tree, derived from
    (leaf shapes, k, bucket_bytes) alone."""
    k: int
    buckets: tuple[BucketSpec, ...]
    small: tuple[int, ...]       # leaf indices exchanged whole
    treedef: Any
    shapes: tuple
    dtypes: tuple

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def _leaf_size(shape) -> int:
    return int(prod(shape)) if len(shape) else 1


def make_rs_plan(tree, k: int, bucket_bytes: int = 0,
                 small_leaf: int = _SMALL_LEAF) -> RSPlan:
    """Pack a tree's leaves (tensors; only shapes and dtypes are read) into
    reduce-scatter buckets: one per big leaf with ``bucket_bytes=0``, else
    consecutive big leaves greedily packed up to ``bucket_bytes`` of fp32."""
    leaves, treedef = flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    small, groups, cur, cur_b = [], [], [], 0
    for i, shape in enumerate(shapes):
        n = _leaf_size(shape)
        if n <= small_leaf:
            small.append(i)
            continue
        if bucket_bytes and cur and cur_b + n * 4 > bucket_bytes:
            groups.append(cur)
            cur, cur_b = [], 0
        cur.append(i)
        cur_b += n * 4
        if not bucket_bytes:
            groups.append(cur)
            cur, cur_b = [], 0
    if cur:
        groups.append(cur)
    buckets = []
    for g in groups:
        sizes = tuple(_leaf_size(shapes[i]) for i in g)
        shard_len = -(-sum(sizes) // k)
        buckets.append(BucketSpec(tuple(g), sizes, shard_len, shard_len * k))
    return RSPlan(k, tuple(buckets), tuple(small), treedef, shapes, dtypes)


# ---------------------------------------------------------------------------
# per-bucket halves on flat fp32 tensors
# ---------------------------------------------------------------------------

def _to_wire(x, dtype):
    if dtype is None:
        return x
    if dtype == torch.float16:
        return quant_fp16(x)
    return x.to(dtype)


def _from_wire(x):
    if x.dtype == torch.float16:
        return dequant_fp16(x)
    return x.float()


def _quant_rows(cf):
    """Per-row absmax int8: (k, s) fp32 -> (q int8, scale (k, 1) fp32)."""
    scale = cf.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(cf / scale), -127, 127).to(torch.int8)
    return q, scale


def _across_pods(s, tr):
    """The cross-pod leg: the fp32 all-reduce of the 1/k shard."""
    return s if tr.lead is None else tr.lead.all_reduce(s)


def _rs_ar(flat, tr, inv_k, transfer_dtype):
    """reduce_scatter_tensor: fp32 on the wire."""
    return _across_pods(tr.reduce_scatter(flat), tr) * inv_k


def _rs_asa(flat, tr, inv_k, transfer_dtype):
    """All-to-all -> local fp32 sum (paper Fig 2; the ``chunk_sum``
    kernel on the card)."""
    chunks = flat.reshape(tr.k, -1)
    if transfer_dtype == torch.int8 and tr.lead is not None:
        transfer_dtype = torch.float16   # int8 scales stop at the pod
    if transfer_dtype == torch.int8:
        q, scale = _quant_rows(chunks)
        recv, rscale = tr.all_to_all(q), tr.all_to_all(scale)
        s = (recv.float() * rscale).sum(dim=0)
    else:
        s = chunk_sum(tr.all_to_all(_to_wire(chunks, transfer_dtype)))
    return _across_pods(s, tr) * inv_k


RAW_SINGLE_LEVEL = ("the raw reduce-scatter (and the fused RS update) is "
                    "single-level: a two-level (hier) transport sums each "
                    "shard across pods before the update")


def _rs_asa_raw(flat, tr, transfer_dtype):
    """Transfer-only RS half: the (k, s) receives before summation, and
    their (k,) int8 scales or None. The caller owns the mean divisor.
    Single-level only."""
    if tr.lead is not None:
        raise ValueError(RAW_SINGLE_LEVEL)
    chunks = flat.reshape(tr.k, -1)
    if transfer_dtype == torch.int8:
        q, scale = _quant_rows(chunks)
        return tr.all_to_all(q), tr.all_to_all(scale).reshape(-1)
    return tr.all_to_all(_to_wire(chunks, transfer_dtype)), None


def _rs_ring(flat, tr, inv_k, transfer_dtype):
    """Ring reduce-scatter: at hop s rank i sends its partial of chunk
    (i - s - 1) % k at the wire dtype and adds its own copy of chunk
    (i - s - 2) % k to what it receives, so after k - 1 hops it holds
    chunk i fully reduced (the sharded update's layout). Across pods it
    stages like ``asa``, as the reference's does."""
    if tr.lead is not None:
        return _rs_asa(flat, tr, inv_k, transfer_dtype)
    k, i = tr.k, tr.rank
    if k == 1:
        return flat * inv_k
    x = flat.reshape(k, -1)
    acc = x[(i - 1) % k]
    for s in range(k - 1):
        recv = _from_wire(tr.send_recv(_to_wire(acc, transfer_dtype)))
        acc = recv + x[(i - s - 2) % k]
    return acc * inv_k


def _ag_ring(shard, tr, transfer_dtype):
    """Ring all-gather: after s hops rank i holds rank (i - s)'s shard,
    rounded to the wire dtype once per hop (its own shard stays fp32).
    Two-level: the pod's all-gather, as ``asa``'s."""
    if tr.lead is not None:
        return _ag_flat(shard, tr, transfer_dtype)
    k, i = tr.k, tr.rank
    if k == 1:
        return shard
    buf = torch.empty((k, shard.shape[0]), dtype=torch.float32,
                      device=shard.device)
    buf[i] = shard
    cur = shard
    for s in range(1, k):
        cur = _from_wire(tr.send_recv(_to_wire(cur, transfer_dtype)))
        buf[(i - s) % k] = cur
    return buf.reshape(-1)


def _ag_flat(shard, tr, transfer_dtype):
    """All-gather the (s,) fp32 shard to (k s,) at the wire dtype (int8
    requantizes with one fp32 scale per shard)."""
    if transfer_dtype == torch.int8:
        scale = shard.abs().amax() / 127.0 + 1e-12
        q = torch.clamp(torch.round(shard / scale), -127, 127).to(torch.int8)
        out_q = tr.all_gather(q)
        out_s = tr.all_gather(scale.reshape(1))
        return out_q.float() * torch.repeat_interleave(out_s, shard.shape[0])
    return _from_wire(tr.all_gather(_to_wire(shard, transfer_dtype)))


_RS_FNS = {"ar": _rs_ar, "asa": _rs_asa, "ring": _rs_ring}
_AG_FNS = {"ar": _ag_flat, "asa": _ag_flat, "ring": _ag_ring}


# ---------------------------------------------------------------------------
# tree-level exchanger
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Exchanger:
    """Named strategy applied bucket-wise to a tree. ``kind`` is the
    collective family (``ar`` | ``asa`` | ``ring`` | ``none``);
    ``transfer_dtype`` is the wire format of both halves (None: fp32).
    Every method takes a process group (None: the default one) or a
    :class:`Transport`."""
    name: str
    kind: str
    transfer_dtype: Any = None

    @staticmethod
    def pack_bucket(leaves, b: BucketSpec):
        """One bucket's flat fp32 padded tensor from the flat leaves."""
        f = torch.cat([leaves[i].reshape(-1).float() for i in b.leaves])
        pad = b.padded - f.shape[0]
        if pad:
            f = torch.nn.functional.pad(f, (0, pad))
        return f

    @staticmethod
    def pack(tree, plan: RSPlan):
        """-> (flat fp32 padded bucket list, small-leaf list, leaves)."""
        leaves = flatten(tree)[0]
        flats = [Exchanger.pack_bucket(leaves, b) for b in plan.buckets]
        return flats, [leaves[i] for i in plan.small], leaves

    @staticmethod
    def unpack(flats, smalls, plan: RSPlan):
        """Inverse of ``pack``: the tree at its original shapes/dtypes."""
        out = [None] * len(plan.shapes)
        for b, f in zip(plan.buckets, flats):
            off = 0
            for i, n in zip(b.leaves, b.sizes):
                out[i] = f[off:off + n].reshape(plan.shapes[i]).to(
                    plan.dtypes[i])
                off += n
        for i, s in zip(plan.small, smalls):
            out[i] = s.to(plan.dtypes[i]).reshape(plan.shapes[i])
        return unflatten(plan.treedef, out)

    @property
    def supports_raw(self) -> bool:
        """Whether ``reduce_scatter(raw=True)`` can hand un-summed chunks
        to the fused RS+update kernel (the all-to-all family, on a
        single-level transport)."""
        return self.kind == "asa"

    def reduce_scatter(self, grads, group=None, *, bucket_bytes: int = 0,
                       plan: RSPlan | None = None, raw: bool = False):
        """Mean-reduce and scatter: this rank keeps the fp32 shard of every
        bucket plus the all-reduced small leaves. Returns ``({"shards",
        "full"}, plan)``, or with ``raw=True`` ``{"chunks", "scales",
        "full"}`` with the un-summed (k, s) receives."""
        if self.kind == "none":
            raise ValueError("'none' exchanger has no reduce_scatter half")
        tr = as_transport(group)
        if plan is None:
            plan = make_rs_plan(grads, tr.k, bucket_bytes)
        inv_k = 1.0 / tr.world_k
        flats, smalls, _ = self.pack(grads, plan)
        full = [tr.all_reduce(s.float()) * inv_k for s in smalls]
        if raw:
            if not self.supports_raw:
                raise ValueError(
                    f"raw reduce-scatter unsupported for {self.name!r}")
            pairs = [_rs_asa_raw(f, tr, self.transfer_dtype) for f in flats]
            return {"chunks": [p[0] for p in pairs],
                    "scales": [p[1] for p in pairs if p[1] is not None],
                    "full": full}, plan
        rs = _RS_FNS[self.kind]
        shards = [rs(f, tr, inv_k, self.transfer_dtype) for f in flats]
        return {"shards": shards, "full": full}, plan

    def reduce_scatter_start(self, grads, group=None, *, plan: RSPlan,
                             raw: bool = False) -> PendingReduceScatter:
        """:meth:`reduce_scatter` with the buckets' all-to-alls started
        and not waited for (the all-to-all family; the other families run
        their reduce-scatter here at once). ``.finish()`` on the result
        returns what ``reduce_scatter`` does. Buckets are packed, cast
        and sent one at a time, so one bucket's fp32 copy is alive at
        once. The small leaves are all-reduced by ``finish``, after the
        all-to-alls: no other collective runs while they are in flight."""
        tr = as_transport(group)
        if self.kind != "asa":
            res, _ = self.reduce_scatter(grads, tr, plan=plan, raw=raw)
            return PendingReduceScatter(tr, raw, None, res)
        if raw and not self.supports_raw:
            raise ValueError(f"raw reduce-scatter unsupported for "
                             f"{self.name!r}")
        if raw and tr.lead is not None:
            raise ValueError(RAW_SINGLE_LEVEL)
        leaves = flatten(grads)[0]
        wire = self.transfer_dtype
        if wire == torch.int8 and tr.lead is not None:
            wire = torch.float16                 # as _rs_asa
        k = tr.k

        def sends():
            for b in plan.buckets:
                chunks = self.pack_bucket(leaves, b).reshape(k, -1)
                if wire == torch.int8:
                    q, scale = _quant_rows(chunks)
                    yield q
                    yield scale
                else:
                    yield _to_wire(chunks, wire)

        pending = tr.all_to_all_start(sends())
        smalls = [leaves[i] for i in plan.small]
        return PendingReduceScatter(tr, raw, (pending, smalls, wire), None)

    def all_gather(self, shards, plan: RSPlan, group=None, *,
                   wire_dtype=...):
        """(s,) fp32 shards -> (k s,) flat buckets at the wire dtype
        (``wire_dtype`` overrides the strategy's)."""
        if wire_dtype is ...:
            wire_dtype = self.transfer_dtype
        tr = as_transport(group)
        ag = _AG_FNS[self.kind]
        return [ag(s, tr, wire_dtype) for s in shards]

    def exchange(self, grads, group=None, bucket_bytes: int = 0):
        """Mean-reduce ``grads`` across the group: ``reduce_scatter`` then
        ``all_gather``, or one ``all_reduce`` per bucket for ``ar``."""
        if self.kind == "none":
            return grads
        tr = as_transport(group)
        plan = make_rs_plan(grads, tr.k, bucket_bytes)
        if self.kind == "ar":
            inv_k = 1.0 / tr.world_k
            flats, smalls, _ = self.pack(grads, plan)
            red = [tr.all_reduce(f) * inv_k for f in flats]
            full = [tr.all_reduce(s.float()) * inv_k for s in smalls]
            return self.unpack(red, full, plan)
        res, plan = self.reduce_scatter(grads, tr, plan=plan)
        flats = self.all_gather(res["shards"], plan, tr)
        return self.unpack(flats, res["full"], plan)


class PendingReduceScatter:
    """A reduce-scatter in flight (:meth:`Exchanger.reduce_scatter_start`)."""

    def __init__(self, tr: Transport, raw: bool, inflight, done):
        """``inflight``: (the pending all-to-all, the small leaves, the
        wire dtype); ``done``: the finished result instead."""
        self.tr, self.raw = tr, raw
        self._inflight, self._done = inflight, done

    def finish(self) -> dict:
        if self._done is not None:
            return self._done
        pending, smalls, wire = self._inflight
        tr, inv_k = self.tr, 1.0 / self.tr.world_k
        recv = pending.wait()
        full = [tr.all_reduce(s.float()) * inv_k for s in smalls]
        if wire == torch.int8:
            pairs = [(recv[i], recv[i + 1]) for i in range(0, len(recv), 2)]
        else:
            pairs = [(r, None) for r in recv]
        if self.raw:
            return {"chunks": [q for q, _ in pairs],
                    "scales": [sc.reshape(-1) for _, sc in pairs
                               if sc is not None],
                    "full": full}
        shards = []
        for q, sc in pairs:
            s = (q.float() * sc).sum(dim=0) if sc is not None else \
                chunk_sum(q)
            shards.append(_across_pods(s, tr) * inv_k)
        return {"shards": shards, "full": full}


EXCHANGERS: dict[str, Exchanger] = {
    "ar": Exchanger("ar", "ar"),
    "asa": Exchanger("asa", "asa"),
    "asa16": Exchanger("asa16", "asa", torch.float16),
    "asabf16": Exchanger("asabf16", "asa", torch.bfloat16),
    "asa8": Exchanger("asa8", "asa", torch.int8),
    "ring": Exchanger("ring", "ring"),
    "ring16": Exchanger("ring16", "ring", torch.float16),
    "hier": Exchanger("hier", "asa"),
    "hier16": Exchanger("hier16", "asa", torch.float16),
    "none": Exchanger("none", "none"),
}
# strategies of the JAX package that are not ported yet (none left)
NOT_PORTED: tuple = ()


def get_exchanger(name: str) -> Exchanger:
    if name not in EXCHANGERS:
        raise KeyError(f"unknown exchanger {name!r}; known: "
                       f"{sorted(EXCHANGERS)}")
    return EXCHANGERS[name]


def param_wire_dtype(exchanger: Exchanger):
    """Wire format of the updated-parameter all-gather on the RS -> update
    -> AG path: the strategy's, except that int8 strategies gather
    parameters at fp16."""
    if exchanger.transfer_dtype == torch.int8:
        return torch.float16
    return exchanger.transfer_dtype


def _dtype_name(dtype) -> str:
    return str(dtype or torch.float32).replace("torch.", "")


def _dtype_bytes(dtype) -> int:
    return 4 if dtype is None else torch.empty((), dtype=dtype).element_size()


def wire_summary(exchanger: Exchanger, plan: RSPlan, *,
                 param_ag: bool = False, sync_every: int = 1) -> dict:
    """Analytic per-rank bytes on the wire for one exchange over ``plan``
    (egress; the same model as the JAX package's ``wire_summary``)."""
    k = plan.k
    g_sz = _dtype_bytes(exchanger.transfer_dtype)
    ag_dtype = (param_wire_dtype(exchanger) if param_ag
                else exchanger.transfer_dtype)
    a_sz = _dtype_bytes(ag_dtype)
    int8_rs = exchanger.transfer_dtype == torch.int8
    int8_ag = ag_dtype == torch.int8
    rs_b = ag_b = 0
    per_bucket = []
    for b in plan.buckets:
        if exchanger.kind == "none":
            rs, ag = 0, 0
        elif exchanger.kind == "ar":
            half = int(2 * (k - 1) / k * b.padded * 4 / 2)
            rs, ag = half, half
        else:
            rs = (k - 1) * b.shard_len * g_sz
            if int8_rs:
                rs += (k - 1) * 4            # per-row fp32 scales
            ag = (k - 1) * b.shard_len * a_sz
            if int8_ag:
                ag += (k - 1) * 4            # one fp32 scale per shard
        rs_b += rs
        ag_b += ag
        per_bucket.append({"leaves": len(b.leaves), "padded": b.padded,
                           "rs_bytes": rs, "ag_bytes": ag})
    small_b = 0 if exchanger.kind == "none" else sum(
        int(2 * (k - 1) / k * prod(plan.shapes[i] or (1,)) * 4)
        for i in plan.small)
    total = rs_b + ag_b + small_b
    return {
        "strategy": exchanger.name,
        "wire_dtype": _dtype_name(exchanger.transfer_dtype),
        "ag_dtype": _dtype_name(ag_dtype),
        "k": k,
        "num_buckets": plan.num_buckets,
        "rs_bytes": rs_b,
        "ag_bytes": ag_b,
        "small_bytes": small_b,
        "bytes_per_exchange": total,
        "sync_every": sync_every,
        "bytes_per_step": total / max(sync_every, 1),
        "per_bucket": per_bucket,
    }
