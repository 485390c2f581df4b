"""Dry run: build every (arch x input shape) program on the production
meshes and cost it, without a card (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out /tmp/dryrun

The reference lowers and compiles an XLA program for 256 (or 512) TPU
devices and reads its memory, cost and collectives analysis. An eager
PyTorch program has no compiled form, so the port runs it once, on
tensors of the ``meta`` device (shapes and dtypes, no memory, no
arithmetic), as one device of the mesh sees it:

- the world is PyTorch's fake process group at the mesh's size, this
  process rank 0 (``launch/mesh.py``): every collective takes its
  tensors and moves nothing;
- the data axes (``data``, or ``pod`` x ``data``) are the port's own:
  the BSP step's exchanger and the gspmd step's gathers issue their
  collectives on rank 0's data group, as on the card, and the batch is
  that rank's share (``batch_shardings``);
- the ``model`` axis is DTensor on a one-dimensional ``DeviceMesh``:
  each parameter (and cache) leaf is rank 0's shard under the
  reference's rule table (``param_shardings``, ``cache_shardings``; in
  gspmd mode the model entries of ``fsdp_param_spec``), wrapped with its
  placement, so DTensor's sharding propagation issues the tensor-parallel
  collectives; ``act.constrain`` shards the residual stream between
  layers (``--no-seq-shard`` turns it off); attention and the SSM mixer
  run per head, the MoE layer per expert shard and the embedding per
  vocab shard, each on its local shards as ``local_map`` runs a function
  (``models/tp.py``, which replicates where the reference's
  ``sanitize_spec`` would drop the sharding);
- the hand kernels take their meta paths: each reports the cost it
  reports on the card and launches nothing (``kernels.launches``).

A ``CostMode`` counts that run: flops, HBM bytes and collectives by
kind, one device's share (``roofline/analysis.py``; DTensor ops are
counted through the ops on their local shards), against the H100 SXM's
peaks; ``collective_bytes_by_site`` splits the forward's collectives by
the ``models/tp.py`` site that issued them. The same mode tracks the meta storages the run allocates: the
peak of those alive at once is ``memory.temp_bytes``; the shards of
state and batch that the program takes are ``memory.argument_bytes`` (the
step counter, a host integer in the port, counted at the reference's
4-byte int32), and ``peak_bytes`` is their sum. Those are predictions
for an H100 ("dry run, meta device, H100 SXM peaks"), not measurements.

An eager run costs every layer, so the reference's ``_extrapolate`` (XLA
costs a scanned layer body once, so it compiles twice and extrapolates)
has no counterpart. ``needs_fsdp`` keeps the reference's rule and its
``FSDP_THRESHOLD_BYTES`` so that both packages pick the same mode; that
threshold is the reference's, derived for a TPU v5e chip, not an H100
figure. Decode runs at the last position of the shape's sequence (a
full cache: the flash decode's cost depends on the position, XLA's
dense program's does not). ``--attn-impl ref`` takes the einsum
attention, the reference's choice on its CPU host
(``repro/models/attention.py:48-52``); the default is the card's flash
kernels. ``--block-kv`` other than 0 is refused: the blockwise attention
is not ported (ROADMAP queue 1 item 5). A row that fails is written with
``ok: false`` and its error, as the reference writes it.

Nothing here touches CUDA: ``torch.cuda.is_initialized()`` stays false.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import kernels as K
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import INPUT_SHAPES, with_attn_impl
from repro_torch.configs.registry import ASSIGNED_ARCHS
from repro_torch.core.bsp import init_sharded_train_state, make_bsp_step
from repro_torch.core.exchanger import Transport, get_exchanger
from repro_torch.core.gspmd import LeafSpec, make_gspmd_step
from repro_torch.dist import act
from repro_torch.dist.sharding import (MODEL_AXIS, Mesh, batch_shardings,
                                       cache_shardings, dp_axes_of,
                                       dp_size_of, fsdp_param_spec,
                                       local_shape, map_named,
                                       param_shardings, set_replicate_attn,
                                       spec_leaves)
from repro_torch.kernels.fused_sgd import fused_sgd
from repro_torch.launch.mesh import (data_group, device_mesh, fake_world,
                                     make_production_mesh, mesh_label)
from repro_torch.launch.specs import (abstract_cache, abstract_params,
                                      decode_batch_specs, meta,
                                      train_batch_specs)
from repro_torch.models import tp
from repro_torch.models.registry import build_model
from repro_torch.optim import constant, sgd_momentum
from repro_torch.roofline.analysis import (CostMode, Roofline,
                                           model_flops_6nd)
from repro_torch.tree import flatten, leaves, unflatten

# replicated-DP (paper-faithful BSP) is infeasible above this per-device
# bound; larger archs take the GSPMD/ZeRO-1 path. The reference's figure
# for a TPU v5e chip (16 GB of HBM), kept so that both packages pick the
# same mode, not an H100 figure.
FSDP_THRESHOLD_BYTES = 12e9
# the step counter: a host int in the port, an int32 argument in the
# reference, counted as the reference counts it
STEP_BYTES = 4


def needs_fsdp(cfg, mesh: Mesh) -> bool:
    tp_ = mesh.shape.get(MODEL_AXIS, 1)
    per_device = cfg.param_count() * 4 * 3 / tp_  # params+momentum+grads
    return per_device > FSDP_THRESHOLD_BYTES


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local(tree, specs, mesh: Mesh):
    """Meta tensors of one device's shard of every leaf of ``tree``."""
    ls, td = flatten(tree)
    return unflatten(td, [meta(local_shape(tuple(x.shape), s, mesh),
                               x.dtype) for x, s in zip(ls,
                                                        spec_leaves(specs))])


def _batch_only(tree, specs, mesh: Mesh, batch: int):
    """``specs`` with each data-axis entry kept only on a dim of the
    global ``batch``'s size: the port runs one program a data rank, which
    holds its share of the batch; a data entry that ``sanitize_spec``
    moved off the batch dim (a batch the data ranks do not divide, as
    long_500k's one sequence) leaves the leaf whole on every data rank."""
    dp = set(dp_axes_of(mesh))

    def keep(e, size):
        names = set(e) if isinstance(e, (tuple, list)) else {e}
        return e if not (names & dp) or size == batch else None
    ls = leaves(tree)
    return unflatten(flatten(tree)[1], [
        tuple(keep(e, x.shape[i]) for i, e in enumerate(sp))
        for x, sp in zip(ls, spec_leaves(specs))])


def _bf16_params(params):
    """The reference's ``_bf16_params``: fp32 leaves of rank >= 2 as bf16
    (the serving dtype), the rest as they are. It casts its stacked
    leaves, so a layer's fp32 vectors (norm scales, biases), one rank
    more there, are cast too."""
    def cast(names, x):
        rank = x.ndim + (1 if names and names[0] == "layers" else 0)
        if x.dtype == torch.float32 and rank >= 2:
            return meta(x.shape, torch.bfloat16)
        return x
    return map_named(cast, params)


class TraceMode(CostMode):
    """A :class:`CostMode` that also tracks the storages its ops allocate
    (outputs that alias no input): ``peak_bytes`` is the most alive at
    once, ``live_bytes`` those alive now."""

    def __init__(self):
        super().__init__()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs: dict = {}

    def _count(self, func, args, kwargs, out) -> None:
        super()._count(func, args, kwargs, out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return
        ins = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in ins or key in self._refs:
                continue
            n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._refs[key] = weakref.ref(st, self._freed(key, n))

    def _freed(self, key, n):
        def cb(_):
            self._refs.pop(key, None)
            self.live_bytes -= n
        return cb


@dataclasses.dataclass
class Program:
    """One built program: ``fn()`` runs it once; ``args`` are the
    tensors it takes (state and batch shards); ``mode`` its train mode
    or kind."""
    fn: object
    args: object
    mode: str
    extra_arg_bytes: int = 0


def _recipe(optimizer=None):
    """The dry run's optimizer: the reference's ``sgd_momentum(
    weight_decay=0.0)``, its update through the ``fused_sgd`` kernel as
    on the card."""
    return optimizer or sgd_momentum(momentum=0.9, weight_decay=0.0,
                                     fused_kernel=fused_sgd)


def build_train(cfg, shape, mesh: Mesh, exchanger_name: str = "asa",
                mode_override=None, *, model_mesh=None, optimizer=None,
                lr_fn=None, sharded_update: bool = False) -> Program:
    """One training step of rank 0 (module docstring). ``mode``: ``bsp``
    (the exchanger; ``sharded_update`` its RS -> update -> AG path) or
    ``fsdp``/``zero1``/``ar`` (``core/gspmd.py``). The BSP exchange
    buckets as the training loop does, one bucket a leaf of the port's
    per-layer tree, where the reference's stacked leaves make one bucket
    a leaf for all layers: the bytes by kind are the same, the counts
    are the layers' times more."""
    model = build_model(cfg, "meta")
    opt = _recipe(optimizer)
    lr_fn = lr_fn or constant(0.01)
    batch = train_batch_specs(cfg, shape)
    batch = _local(batch, _batch_only(batch, batch_shardings(mesh, batch),
                                      mesh, shape.global_batch), mesh)
    tr = Transport(data_group(mesh))
    mode = mode_override or ("fsdp" if needs_fsdp(cfg, mesh) else "bsp")
    full = abstract_params(model)
    if mode == "bsp":
        tmodel = tp.tp_model(model, model_mesh, None)
        step = make_bsp_step(tmodel, opt, get_exchanger(exchanger_name),
                             lr_fn, tr, sharded_update=sharded_update)
        if sharded_update:
            state = init_sharded_train_state(model, opt, torch.Generator(),
                                             tr)
        else:
            state = {"params": full, "opt": opt.init(full), "step": 0}
    else:
        gmode = "zero1" if mode in ("fsdp", "zero1") else "ar"
        fspecs = map_named(lambda names, x: fsdp_param_spec(
            names, tuple(x.shape), mesh), full)
        dp, dpk = dp_axes_of(mesh), dp_size_of(mesh)
        dpe = dp if len(dp) > 1 else (dp[0] if dp else None)

        def leaf_spec(x, s):
            shape_m = local_shape(tuple(x.shape), tuple(
                e if e == MODEL_AXIS else None for e in s), mesh)
            dim = s.index(dpe) if dpe is not None and dpe in s else None
            return LeafSpec(shape_m, dim, dpk)

        ls, td = flatten(full)
        specs = unflatten(td, [leaf_spec(x, s) for x, s in
                               zip(ls, spec_leaves(fspecs))])
        model_specs = map_named(lambda names, x: tuple(
            e if e == MODEL_AXIS else None
            for e in fsdp_param_spec(names, tuple(x.shape), mesh)), full)
        tmodel = tp.tp_model(model, model_mesh, model_specs)
        params = unflatten(td, [meta(s.shard_shape, x.dtype) for x, s in
                                zip(ls, leaves(specs))])
        state = {"params": params, "opt": opt.init(params), "step": 0}
        step = make_gspmd_step(tmodel, opt, lr_fn, specs, tr, mode=gmode)
    return Program(lambda: step(state, batch), (state, batch), mode,
                   STEP_BYTES)


def build_prefill(cfg, shape, mesh: Mesh, *, model_mesh=None) -> Program:
    model = build_model(cfg, "meta")
    params = _bf16_params(abstract_params(model))
    specs = param_shardings(mesh, params)
    params = _local(params, specs, mesh)
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels", None)
    batch = _local(batch, _batch_only(batch, batch_shardings(mesh, batch),
                                      mesh, shape.global_batch), mesh)
    tmodel = tp.tp_model(model, model_mesh, specs)
    return Program(lambda: tmodel.forward(params, batch), (params, batch),
                   "prefill")


def build_decode(cfg, shape, mesh: Mesh, *, model_mesh=None) -> Program:
    model = build_model(cfg, "meta")
    params = _bf16_params(abstract_params(model))
    pspecs = param_shardings(mesh, params)
    params = _local(params, pspecs, mesh)
    cache = abstract_cache(model, cfg, shape)
    cspecs = _batch_only(cache, cache_shardings(mesh, cache,
                                                shape.global_batch),
                         mesh, shape.global_batch)
    cache = _local(cache, cspecs, mesh)
    batch = decode_batch_specs(cfg, shape)
    batch = _local(batch, _batch_only(batch, batch_shardings(mesh, batch),
                                      mesh, shape.global_batch), mesh)
    tmodel = tp.tp_model(model, model_mesh, pspecs, cache_specs=cspecs)
    pos = shape.seq_len - 1

    def fn():
        with K.meta_positions(pos):
            logits, new_cache = tmodel.decode_step(params, cache, batch, pos,
                                                   seq_len=shape.seq_len)
        return torch.argmax(logits[:, -1, :], dim=-1), new_cache

    return Program(fn, (params, cache, batch), "decode", STEP_BYTES)


def analyze_program(prog: Program, model_flops_per_device: float) -> dict:
    """The reference's ``{"roofline", "collectives", "memory"}`` of one
    run of ``prog`` (module docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_b = _bytes(prog.args) + prog.extra_arg_bytes
    mode = TraceMode()
    with mode, implicit_replication():
        out = prog.fn()
    if mode.errors:
        raise RuntimeError(f"{mode.errors} ops uncounted, first "
                           f"{mode.first_error}")
    out_b = _bytes(out)
    del out
    rl = Roofline(mode.flops, mode.hbm_bytes, mode.collectives.total_bytes,
                  model_flops=model_flops_per_device)
    return {
        "roofline": rl.as_dict(),
        "collectives": {"counts": dict(mode.collectives.counts),
                        "bytes_by_kind": dict(
                            mode.collectives.bytes_by_kind)},
        # the forward's collectives by ``models/tp.py``'s sites
        "collective_bytes_by_site": dict(mode.collectives.bytes_by_site),
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": mode.peak_bytes,
                   "peak_bytes": arg_b + mode.peak_bytes},
        "kernels": mode.kernels,
        "bytes_by_op": mode.bytes_by_op,
    }


def build(cfg, shape, mesh: Mesh, exchanger: str = "asa",
          mode_override=None, model_mesh=None) -> Program:
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, exchanger, mode_override,
                           model_mesh=model_mesh)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, model_mesh=model_mesh)
    return build_decode(cfg, shape, mesh, model_mesh=model_mesh)


def _clear_sharding_caches() -> None:
    """Drop DTensor's sharding-propagation caches: a later row's mesh has
    the same dim names and sizes as an earlier row's, and an entry cached
    on the earlier world mis-shaped a later row's op (llama4-scout after
    seamless, on one host mesh)."""
    from torch.distributed.tensor import DTensor
    sp = DTensor._op_dispatcher.sharding_propagator
    sp.propagate_op_sharding.cache_clear()
    sp._propagate_tensor_meta_cached.cache_clear()


@contextlib.contextmanager
def mesh_world(mesh: Mesh):
    """The fake world of ``mesh``'s size and rank 0's model-axis
    ``DeviceMesh`` (None on a mesh without a model axis of more than one
    device)."""
    n = 1
    for s in mesh.sizes:
        n *= s
    _clear_sharding_caches()
    with fake_world(n):
        mm = None
        if mesh.shape.get(MODEL_AXIS, 1) > 1:
            mm = device_mesh(mesh)[MODEL_AXIS]
        yield mm


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            exchanger: str = "asa", seq_shard: bool = True,
            mode_override=None, block_kv: int = 0,
            replicate_attn: bool = False, attn_impl: str = "flash",
            mesh: Mesh | None = None) -> dict:
    """One row: the program of ``arch`` at ``shape_name`` on the
    production mesh (or ``mesh``), built and costed; ``ok: false`` with
    the error when that fails."""
    set_replicate_attn(replicate_attn)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_label(mesh),
              "exchanger": exchanger, "unrolled": True, "block_kv": block_kv,
              "attn_impl": attn_impl}
    t0 = time.time()
    try:
        if block_kv:
            raise NotImplementedError(
                "--block-kv: the JAX package's blockwise attention scan is "
                "not ported (ROADMAP queue 1 item 5)")
        cfg = with_attn_impl(get_config(arch), attn_impl)
        shape = get_shape(shape_name)
        chips = 1
        for s in mesh.sizes:
            chips *= s
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        mf = model_flops_6nd(cfg.active_param_count(), tokens,
                             "train" if shape.kind == "train" else "infer")
        # sequence-parallel constraint: the residual stream's feature dim
        # over 'model' between layers (none for decode's one token)
        spec = ((None, None, MODEL_AXIS)
                if seq_shard and shape.kind != "decode" else None)
        with mesh_world(mesh) as mm:
            prog = build(cfg, shape, mesh, exchanger, mode_override, mm)
            result["mode"] = prog.mode
            with act.activation_spec(spec):
                res = analyze_program(prog, mf / chips)
            del prog
        res.pop("bytes_by_op")
        result.update(res)
        result["compile_s"] = round(time.time() - t0, 1)
        result["ok"] = True
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    finally:
        set_replicate_attn(False)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (assigned archs)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--exchanger", default="asa")
    ap.add_argument("--mode", default=None,
                    help="override train mode: bsp|zero1|ar")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--block-kv", type=int, default=0,
                    help="blockwise attention KV block (not ported: only 0)")
    ap.add_argument("--attn-impl", default="flash", choices=["flash", "ref"],
                    help="the card's flash kernels (their meta paths) or the "
                         "einsum attention")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="", help="extra tag suffix for output")
    ap.add_argument("--replicate-attn", action="store_true",
                    help="replicate attention/SSM params (no TP on them)")
    args = ap.parse_args(argv)
    if args.block_kv:
        ap.error("--block-kv: the JAX package's blockwise attention scan is "
                 "not ported (ROADMAP queue 1 item 5); use 0")

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.mode:
                    tag += f"__{args.mode}"
                if args.exchanger != "asa":
                    tag += f"__{args.exchanger}"
                if args.no_seq_shard:
                    tag += "__noseq"
                if args.replicate_attn:
                    tag += "__repattn"
                if args.attn_impl != "flash":
                    tag += f"__{args.attn_impl}"
                if args.tag:
                    tag += f"__{args.tag}"
                res = run_one(arch, shape, mp, args.exchanger,
                              seq_shard=not args.no_seq_shard,
                              mode_override=args.mode,
                              replicate_attn=args.replicate_attn,
                              attn_impl=args.attn_impl)
                path = os.path.join(args.out, tag + ".json")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["ok"]:
                    rl = res["roofline"]
                    print(f"OK  {tag:60s} mode={res.get('mode', '-'):7s} "
                          f"compile={res['compile_s']:6.1f}s "
                          f"t_comp={rl['t_compute_s']:.3e} "
                          f"t_mem={rl['t_memory_s']:.3e} "
                          f"t_coll={rl['t_collective_s']:.3e} "
                          f"dom={rl['dominant']}", flush=True)
                else:
                    failed += 1
                    print(f"FAIL {tag}: {res['error']}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
