"""Training launcher: the paper's BSP and async (EASGD/ASGD) training of
its convnets (AlexNet, GoogLeNet, VGG-16), and of the decoder LMs and the
encoder-decoder, on k ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --ranks 2 --exchanger asa16 --sharded-update --batch 128 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch googlenet \\
        --ranks 2 --exchanger ring16 --steps 20

    # a decoder LM (the JAX package's examples/train_lm_bsp.py recipe):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --ranks 2 --batch 4 --seq 1024 --steps 6 --exchanger asa16 \\
        --sharded-update --ckpt /path/ckpt --ckpt-every 3
    PYTHONPATH=src python -m repro_torch.launch.train --preset train_lm_bsp \\
        --ranks 2 --steps 300 --resume /path/ckpt --ckpt /path/ckpt

    # async EASGD (center exchange every 2 steps), the exchange overlapped
    # with backprop, and the two-level hier16 exchange on 2 pods of 2:
    PYTHONPATH=src python -m repro_torch.launch.train --algo easgd --tau 2
    PYTHONPATH=src python -m repro_torch.launch.train --overlap buckets \\
        --microbatches 2 --exchanger asa16
    PYTHONPATH=src python -m repro_torch.launch.train --ranks 4 --pods 2 \\
        --exchanger hier16 --sharded-update --batch 32
    # the JAX package's examples/easgd_async.py sweep (tau 1, 2, 4 at
    # alpha 0.5, then asgd at tau 2, on asa16):
    PYTHONPATH=src python -m repro_torch.launch.train --preset easgd_async

    # sharded (GSPMD/FSDP) training: each rank holds 1/k of the parameters
    # and optimizer state; zero1 reduce-scatters the gradients (ar:
    # all-reduces them); then on the CPU with AdamW at peak lr 0.01:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --ranks 2 --batch 1 --seq 1024 --steps 2 --algo gspmd --mode zero1
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --device cpu --ranks 2 --batch 2 --seq 16 --steps 4 \
        --algo gspmd --mode zero1 --optimizer adamw --lr 0.01

    # DeepSeek-V2-Lite (MLA + MoE) at full width, its depth cut to the
    # dense first layer and one MoE layer (the loss adds the MoE aux):
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --layers 2 --ranks 2 --batch 2 \
        --seq 1024 --steps 4 --exchanger asa16 --sharded-update

    # SeamlessM4T-v2's encoder-decoder at full width, both stacks cut to 4
    # layers, 4096 stub frames before each sequence (any --algo):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-large-v2 --layers 4 --ranks 2 --batch 2 \\
        --seq 1024 --steps 4 --exchanger asa16 --sharded-update

    # on the CPU, with the kernels' plain versions (a smoke-sized model):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --ranks 2 --batch 4 --seq 64 --steps 4

    # elastic chaos run: 4 slots, quorum-gated EASGD rounds, injected
    # faults (see repro_torch.fault), each slot's telemetry written apart:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --ranks 4 --algo easgd --tau 4 --quorum 2 \\
        --fault-plan 'kill:3@9,corrupt:1@13,join:3@17' --steps 20 \\
        --metrics-out /tmp/m.jsonl --trace-out /tmp/t.json

Starts k rank processes (``torch.multiprocessing``, spawn), each joining
one process group through a file rendezvous in a temporary directory.
The backend is NCCL when every rank has a card of its own, else gloo; on
a host with one card all k ranks share ``cuda:0`` over gloo (NCCL refuses
two ranks on one device), and the exchanger stages each collective
through pinned host memory. The NCCL arm is not exercised by any test of
this repository (it needs k cards).

Each rank reads its own share of every global batch (``batch`` examples)
from batch files that the ``ParallelLoader`` streams to the device: file
j of rank r holds the source's batch ``j * k + r``. Convnets:
``ImageSource`` images at ``image_size + 8`` pixels, cropped to
``image_size`` (the JAX example crops to ``image_size - 8``, which its
full-size AlexNet cannot take), by default 128 a rank for AlexNet, 32 for
GoogLeNet and 16 for VGG-16; momentum SGD 0.9 with weight decay 5e-4 and
the JAX launcher's ``warmup_cosine(0.01, 10, steps)``; convolutions and
matmuls in full fp32 (TF32 off), as the reference computes them. Decoders
(dense, MoE, SSM and hybrid): ``LMTokenSource`` tokens of ``--seq``
positions (int32 tokens and labels, untouched by the loader), after
zero image embeddings for a VLM, beside ``encoder_seq_len`` normal
stub frames for the encoder-decoder (``synthetic_batch``); momentum SGD
0.9 with weight decay 1e-4 and
``warmup_cosine(0.01, 20, steps)``, the JAX package's
``examples/train_lm_bsp.py`` recipe, whose ~100M config ``--preset
train_lm_bsp`` builds. ``--ckpt`` saves checkpoints (every
``--ckpt-every`` steps and at the end; one directory per rank when k > 1)
and ``--resume`` continues from one.

``--optimizer adamw`` swaps the recipe's momentum SGD for AdamW (the
reference launcher's ``adamw()``) and ``--lr`` sets the schedule's peak;
without them the recipe above runs.

The encoder-decoder trains under every ``--algo``, as the decoders do
(its frames ride in each rank's batch).

``--algo easgd|asgd`` trains each rank as an EASGD worker with a center
exchanged every ``--tau`` steps (``--alpha``: the elastic coefficient).
``--algo gspmd`` trains with FSDP shards (``core/gspmd.py``), the
gradients reduce-scattered (``--mode zero1``) or all-reduced (``--mode
ar``); it has no exchanger (``--exchanger`` other than ``asa`` is
refused, as the reference's ``TrainPlan`` refuses it), and each rank
checkpoints its own shards.
``--overlap buckets`` overlaps each microbatch's reduce-scatter with the
next one's backprop (``--microbatches`` >= 2; it implies the sharded
update). ``--pods P`` splits the k ranks into P pods of consecutive
ranks for the two-level exchange (``data_axes=("pod", "data")``; the
``hier``/``hier16`` strategies). ``--preset easgd_async`` is the JAX
package's ``examples/easgd_async.py``: the smoke llama3.2-1b at vocab
256, 8 sequences of 64 tokens a rank, SGD 0.9 without weight decay at
lr 0.02 (asgd 0.02 / k), its four plans one after the other.

``--quorum`` and ``--fault-plan`` (async plans only) route through
``repro_torch.fault.elastic.elastic_train``: the ``--ranks`` processes
are the slots, ``--workers`` of them (default: all) start live,
membership follows the fault plan, and averaging rounds need ``--quorum``
reporters. A worker draws its own ``--batch`` examples of each step from
the source (batch ``step * ranks + row``, images at ``image_size``).
``--metrics-out`` and ``--trace-out`` write the telemetry JSONL and the
Perfetto trace, one file a rank (``<stem>_slot<r><ext>``) when k > 1;
``python -m repro_torch.telemetry.report M_slot0.jsonl`` reads one, its
per-program attribution (``profile/*``: flops, bytes, MFU and bandwidth
shares of the train step and the exchange halves) included.
``--no-profile`` turns that attribution off (``REPRO_TELEMETRY_PROFILE=0``).
``--attn-impl`` picks a decoder's attention: ``flash`` (the kernels; on
the CPU their plain versions), ``ref`` (the einsum oracles) or ``auto``
(flash on the card, ref on the CPU); the reference's ``blockwise`` is not
ported.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import default_device, telemetry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import AttentionConfig, with_attn_impl
from repro_torch.configs.registry import ASSIGNED_ARCHS, PAPER_ARCHS
from repro_torch.core.gspmd import abstract_params
from repro_torch.data.prefetch import ParallelLoader
from repro_torch.data.synthetic import (ImageSource, LMTokenSource,
                                        materialize_batch_files)
from repro_torch.kernels import fused_sgd as fs
from repro_torch.models import build_model, count_params
from repro_torch.optim import adamw, constant, sgd_momentum, warmup_cosine
from repro_torch.train.engine import TrainPlan
from repro_torch.train.loop import train

CROP_MARGIN = 8


# the archs this launcher trains: the paper's convnets, the decoders (dense,
# MoE, SSM and hybrid layers; VLMs with the stub image prefix) and the
# encoder-decoder (stub frames)
TRAIN_ARCHS = tuple(PAPER_ARCHS) + tuple(ASSIGNED_ARCHS)
# examples per rank and step when --batch is not given
CONV_BATCH = {"alexnet": 128, "googlenet": 32, "vggnet": 16}
LM_BATCH = 8


def train_lm_bsp_config():
    """The ~100M llama derivative of the JAX package's
    ``examples/train_lm_bsp.py``: 6 layers, d_model 768, d_ff 2048, vocab
    32768, 12 heads over 4 KV heads of 64, tied embeddings, no remat."""
    return get_config("llama3.2-1b").with_overrides(
        num_layers=6, d_model=768, d_ff=2048, vocab_size=32768,
        attention=AttentionConfig(num_heads=12, num_kv_heads=4, head_dim=64),
        tie_embeddings=True, scan_layers=True, remat=False)


def easgd_async_config():
    """``examples/easgd_async.py``'s model: the smoke llama3.2-1b at vocab
    256."""
    return get_smoke_config("llama3.2-1b").with_overrides(vocab_size=256)


PRESETS = {"train_lm_bsp": train_lm_bsp_config,
           "easgd_async": easgd_async_config}
# presets that run a sequence of plans: (TrainPlan keywords, constant lr,
# whether the lr is divided by the ranks) each
PRESET_RUNS = {
    "easgd_async": tuple(
        (dict(algo="easgd", exchanger="asa16", alpha=0.5, tau=tau), 0.02,
         False) for tau in (1, 2, 4)) + (
        (dict(algo="asgd", exchanger="asa16", tau=2), 0.02, True),),
}
PRESET_BATCH = {"easgd_async": (8, 64)}     # (sequences a rank, tokens)


def attn_impl(choice: str | None, device) -> str | None:
    """``--attn-impl``: ``auto`` is flash on the card and ref on the CPU;
    None leaves the config's (flash)."""
    if choice == "auto":
        return "flash" if torch.device(device).type == "cuda" else "ref"
    return choice


def launch_config(opts):
    if opts.get("preset"):
        cfg = PRESETS[opts["preset"]]()
    else:
        cfg = (get_smoke_config if opts["smoke"] else get_config)(
            opts["arch"])
    if opts.get("layers") and not opts.get("preset"):
        # depth cut at full width (DeepSeek-V2-Lite: 2 = the dense first
        # layer and one MoE layer; an encoder-decoder: both stacks)
        n = opts["layers"]
        cfg = cfg.with_overrides(num_layers=n, **(
            {"num_encoder_layers": n} if cfg.family == "encdec" else {}))
    return with_attn_impl(cfg, attn_impl(opts.get("attn_impl"),
                                         opts.get("device") or "cpu"))


def pick_backend(device: torch.device, k: int) -> str:
    """NCCL when each of the k ranks can have a card of its own."""
    if device.type == "cuda" and torch.cuda.device_count() >= k:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int, backend: str):
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _rank_entry(rank, fn, k, backend, init_file, args):
    # ranks that share a host split its cores for their CPU work
    torch.set_num_threads(max(1, (os.cpu_count() or k) // k))
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=k, rank=rank)
    try:
        fn(rank, k, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, k: int, args=(), backend: str = "gloo") -> None:
    """Run ``fn(rank, k, *args)`` in k spawned processes that form one
    process group; returns when all have ended, raises if one failed."""
    with tempfile.TemporaryDirectory() as td:
        mp.start_processes(_rank_entry,
                           args=(fn, k, backend, os.path.join(td, "rdzv"),
                                 args),
                           nprocs=k, join=True, start_method="spawn")


class RankShare:
    """Rank ``rank``'s share of each global batch of ``source``: its batch
    j is the source's batch ``j * k + rank``."""

    def __init__(self, source, rank: int, k: int):
        self.source, self.rank, self.k = source, rank, k

    def batch(self, batch_size: int, step: int):
        return self.source.batch(batch_size, step * self.k + self.rank)


def synthetic_batch(cfg, batch_size: int, step: int, seq_len: int = 128):
    """The batch at index ``step``, deterministic in (cfg, sizes, step)
    (the reference launcher's ``synthetic_batch``): images for a convnet;
    else ``LMTokenSource`` tokens, with zero image embeddings (B,
    ``num_image_tokens``, d) before them for a ``vlm`` config (the stub
    frontend), or, for an encoder-decoder, ``frames`` (B,
    ``encoder_seq_len``, d) drawn from ``default_rng(step)`` (the stub
    audio frontend)."""
    if cfg.family == "conv":
        return ImageSource(cfg.image_size, cfg.num_classes).batch(
            batch_size, step)
    b = LMTokenSource(cfg.vocab_size, seq_len).batch(batch_size, step)
    if cfg.family == "encdec":
        b["frames"] = np.random.default_rng(step).normal(
            0, 1, (batch_size, cfg.encoder_seq_len,
                   cfg.d_model)).astype(np.float32)
    if cfg.modality == "vlm":
        b["image_embeds"] = np.zeros(
            (batch_size, cfg.num_image_tokens, cfg.d_model), np.float32)
    return b


class _DecoderSource:
    """``synthetic_batch`` of a decoder or encoder-decoder config as a
    batch source."""

    def __init__(self, cfg, seq: int):
        self.cfg, self.seq = cfg, seq

    def batch(self, batch_size: int, step: int):
        return synthetic_batch(self.cfg, batch_size, step, self.seq)


def rank_source(cfg, seq: int = 0):
    """Images at ``image_size + 8`` pixels for a convnet, else
    ``synthetic_batch``'s ``seq`` token positions (and a VLM's image
    embeddings, an encoder-decoder's frames)."""
    if cfg.family == "conv":
        return ImageSource(cfg.image_size + CROP_MARGIN, cfg.num_classes)
    return _DecoderSource(cfg, seq)


def write_rank_batches(cfg, rank: int, k: int, batch: int, count: int,
                       out_dir: str, seq: int = 0) -> list[str]:
    """``count`` batch files of this rank's share of ``rank_source``."""
    return materialize_batch_files(RankShare(rank_source(cfg, seq), rank, k),
                                   out_dir, count, batch)


def rank_loader(cfg, files, device, steps: int, seed: int):
    """Images are mean-subtracted (a zero mean) and cropped; token batches
    pass through as they are."""
    crop = {}
    if cfg.family == "conv":
        crop = dict(image_mean=np.zeros(
            (cfg.image_size + CROP_MARGIN,) * 2 + (3,), np.float32),
            crop=cfg.image_size)
    return ParallelLoader(files, depth=2, device=device, seed=seed,
                          epochs=-(-steps // len(files)), **crop)


def is_elastic(opts) -> bool:
    return opts.get("quorum") is not None or bool(opts.get("fault_plan"))


def slot_path(path: str | None, rank: int, k: int) -> str | None:
    """A per-rank telemetry file: ``<stem>_slot<r><ext>`` when k > 1."""
    if not path or k <= 1:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}_slot{rank}{ext}"


def plan_from_opts(opts) -> TrainPlan:
    """The TrainPlan of the launcher's flags (no ``--exchanger``: ``asa``
    for gspmd, which has none, else ``asa16``)."""
    exchanger = opts["exchanger"] or ("asa" if opts["algo"] == "gspmd"
                                      else "asa16")
    return TrainPlan(algo=opts["algo"], exchanger=exchanger,
                     mode=opts.get("mode") or "zero1", scheme=opts["scheme"],
                     sharded_update=opts["sharded_update"],
                     overlap=opts["overlap"],
                     microbatches=opts["microbatches"],
                     bucket_bytes=opts["bucket_bytes"], tau=opts["tau"],
                     alpha=opts["alpha"], quorum=opts.get("quorum"),
                     data_axes=(("pod", "data") if opts["pods"] > 1
                                else ("data",)))


def recipe(cfg, steps: int, optimizer: str | None = None,
           lr: float | None = None):
    """(optimizer, lr schedule) of the arch's reference recipe. Every
    convnet takes the JAX package's launcher schedule,
    ``warmup_cosine(0.01, 10, steps)``; VGG-16, which has no normalisation,
    needs the warm-up (from He init a first step at 0.01 blows its loss up,
    6.2 to 11,346 in one step at the smoke config). ``optimizer="adamw"``
    takes AdamW with the reference's defaults in place of the momentum
    SGD, and ``lr`` the schedule's peak in place of 0.01."""
    conv = cfg.family == "conv"
    if optimizer == "adamw":
        opt = adamw()
    else:
        opt = sgd_momentum(momentum=0.9, weight_decay=5e-4 if conv else 1e-4,
                           fused_kernel=fs.fused_sgd)
    return opt, warmup_cosine(0.01 if lr is None else lr, 10 if conv else 20,
                              steps)


def set_fp32_math() -> None:
    """Full fp32 convolutions and matmuls (PyTorch lets cuDNN use TF32
    for fp32 convolutions by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def elastic_batch_fn(cfg, batch: int, seq: int, slots: int, device,
                     pool: int = 0):
    """``batch_fn(step, k, row)``: the worker's own ``batch`` examples of
    the step, deterministic in the step and row; a rank draws only its own
    share. With ``pool`` = 0 that is the source's batch
    ``step * slots + row``, drawn on each call; else one of ``pool``
    batches drawn once, batch ``(step + row) % pool`` (host image
    preparation off the step)."""
    src = (ImageSource(cfg.image_size, cfg.num_classes)
           if cfg.family == "conv" else _DecoderSource(cfg, seq))

    def draw(i):
        return {n: torch.from_numpy(v).to(device)
                for n, v in src.batch(batch, i).items()}
    if pool:
        drawn = [draw(j) for j in range(pool)]
        return lambda step, k, row: drawn[(step + row) % pool]
    return lambda step, k, row: draw(step * slots + row)


def _elastic_rank(rank, k, opts, cfg, model, dev):
    from repro_torch.fault.elastic import elastic_train
    plan = plan_from_opts(opts)
    opt, lr = recipe(cfg, opts["steps"], opts.get("optimizer"),
                     opts.get("lr"))
    say = print if rank == 0 else None
    _, rep = elastic_train(
        model, opt, lr, elastic_batch_fn(cfg, opts["batch"], opts["seq"], k,
                                         dev),
        plan=plan, num_workers=opts["workers"], num_steps=opts["steps"],
        fault_plan=opts["fault_plan"], log_every=5, ckpt_path=opts["ckpt"],
        ckpt_every=opts["ckpt_every"], resume_from=opts["resume"],
        print_fn=say)
    if say:
        say(f"done: {rep.steps} steps of {cfg.name} ({plan.algo} elastic, "
            f"{k} slots, {dev}), fleet {rep.final_workers}, rounds "
            f"{rep.rounds_synced} synced / {rep.rounds_skipped_quorum} "
            f"below-quorum, kills {rep.kills}, joins {rep.joins}, rebuilds "
            f"{rep.rebuilds}, payloads dropped {rep.payloads_dropped} / "
            f"corrupt {rep.payloads_corrupt}, loss {rep.losses[0]:.4f} -> "
            f"{rep.losses[-1]:.4f}")


def _train_rank(rank, k, opts, backend, data_dir):
    set_fp32_math()
    dev = rank_device(torch.device(opts["device"]), rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if opts.get("metrics_out"):
        telemetry.configure(metrics_out=slot_path(opts["metrics_out"], rank,
                                                  k))
    if opts.get("no_profile"):
        telemetry.configure(profile=False)
    cfg = launch_config(opts)
    model = build_model(cfg, dev)
    try:
        if is_elastic(opts):
            _elastic_rank(rank, k, opts, cfg, model, dev)
        else:
            _train_runs(rank, k, opts, backend, data_dir, cfg, model, dev)
    finally:
        telemetry.flush(force=True)
        if opts.get("trace_out"):
            telemetry.trace.export(slot_path(opts["trace_out"], rank, k))


def _train_runs(rank, k, opts, backend, data_dir, cfg, model, dev):
    batch, seq = opts["batch"], opts["seq"]
    files = write_rank_batches(cfg, rank, k, batch, min(opts["steps"], 8),
                               os.path.join(data_dir, f"rank{rank}"),
                               seq=seq)
    runs = PRESET_RUNS.get(opts.get("preset")) or ((None, None, False),)
    for kw, lr0, by_k in runs:
        plan = TrainPlan(**kw) if kw else plan_from_opts(opts)
        opt, lr = recipe(cfg, opts["steps"], opts.get("optimizer"),
                         opts.get("lr"))
        if lr0 is not None:      # the preset's own recipe
            opt = sgd_momentum(momentum=0.9, weight_decay=0.0,
                               fused_kernel=fs.fused_sgd)
            lr = constant(lr0 / k if by_k else lr0)
        loader = rank_loader(cfg, files, dev, opts["steps"], seed=rank)
        try:
            state, report = train(model, opt, lr, loader, plan=plan,
                                  num_steps=opts["steps"], log_every=5,
                                  ckpt_path=opts["ckpt"],
                                  ckpt_every=opts["ckpt_every"],
                                  resume_from=opts["resume"],
                                  pods=opts["pods"],
                                  print_fn=print if rank == 0 else
                                  (lambda *a: None))
        finally:
            loader.stop()
        if rank == 0:
            _report(cfg, plan, state, report, k, backend, dev, opts["pods"])


def _plan_label(plan: TrainPlan, pods: int) -> str:
    if plan.algo == "gspmd":
        return f"gspmd {plan.mode}"
    label = plan.exchanger
    if plan.is_async:
        label = f"{plan.algo} tau={plan.tau} alpha={plan.alpha} on {label}"
    if plan.sharded_update:
        label += " sharded"
    if plan.overlap:
        label += f" overlap={plan.overlap}"
    if plan.microbatches > 1:
        label += f" microbatches={plan.microbatches}"
    if pods > 1:
        label += f" on {pods} pods"
    return label


def _report(cfg, plan, state, report, k, backend, dev, pods) -> None:
    # a gspmd rank holds shards: count the model's own leaves
    n = count_params(abstract_params(build_model(cfg, "meta"))
                     if plan.algo == "gspmd" else state["params"])
    split = ", ".join(f"{p} {s * 1e3:.1f} ms"
                      for p, s in report.phase_s.items())
    rate = (f"{report.steady_examples_per_s:.1f} images/s"
            if cfg.family == "conv" else
            f"{report.steady_tokens_per_s:.1f} tokens/s")
    losses = (f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}"
              if report.losses else "no steps left to run")
    print(f"done: {report.steps} steps of {cfg.name} ({n:,} params) on "
          f"{k} ranks ({backend}, {dev}), {_plan_label(plan, pods)}: {rate} "
          f"steady (first step {report.first_step_time:.2f} s; per step "
          f"{split}), {losses}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="alexnet", choices=TRAIN_ARCHS)
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="a named config in place of --arch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (convnets: 96 px, 16 classes; "
                         "decoders: 2 layers, d_model 256)")
    ap.add_argument("--exchanger", default=None,
                    help="ar | asa | asa16 | asabf16 | asa8 | ring | ring16 "
                         "| hier | hier16 | none (default asa16; gspmd has "
                         "no exchanger: asa)")
    ap.add_argument("--scheme", default="subgd", choices=["subgd", "awagd"])
    ap.add_argument("--sharded-update", action="store_true",
                    help="RS -> update -> AG on this rank's 1/k shard")
    ap.add_argument("--algo", default="bsp",
                    choices=["bsp", "easgd", "asgd", "gspmd"],
                    help="synchronous BSP, async EASGD/ASGD workers, or "
                         "GSPMD/FSDP shards")
    ap.add_argument("--mode", default="zero1", choices=["zero1", "ar"],
                    help="gspmd: reduce-scatter (zero1) or all-reduce (ar) "
                         "the gradients")
    ap.add_argument("--optimizer", default=None, choices=["sgd", "adamw"],
                    help="the recipe's momentum SGD (default) or AdamW")
    ap.add_argument("--lr", type=float, default=None,
                    help="peak of the warm-up cosine schedule (default "
                         "0.01)")
    ap.add_argument("--tau", type=int, default=1,
                    help="easgd/asgd: steps between center exchanges")
    ap.add_argument("--alpha", type=float, default=None,
                    help="easgd elastic coefficient (default 0.5; asgd is "
                         "pinned to 1)")
    ap.add_argument("--overlap", default=None, choices=["buckets"],
                    help="overlap each microbatch's reduce-scatter with the "
                         "next one's backprop (implies --sharded-update)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="split each rank's batch and accumulate")
    ap.add_argument("--bucket-bytes", type=int, default=0,
                    help="pack leaves into flat buckets of up to this many "
                         "bytes (0: one bucket a leaf)")
    ap.add_argument("--pods", type=int, default=1,
                    help="split the ranks into this many pods for the "
                         "two-level exchange (hier, hier16)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut a decoder's depth to this many layers (an "
                         "encoder-decoder: each of its two stacks)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None,
                    help="examples per rank and step (AlexNet 128, "
                         "GoogLeNet 32, VGG-16 16, decoders 8)")
    ap.add_argument("--seq", type=int, default=256,
                    help="tokens per example (decoders)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory to save into")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save every N steps (0: at the end only)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint directory to continue from")
    ap.add_argument("--quorum", type=int, default=None,
                    help="min reporting workers for an averaging round "
                         "(easgd/asgd); enables the elastic loop")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'kill:1@9,straggle:2@5x3,corrupt:0@13' "
                         "(kind:worker@step[xrounds]); enables the "
                         "elastic loop")
    ap.add_argument("--workers", type=int, default=None,
                    help="elastic: workers live at the start (default: "
                         "--ranks, the slots)")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="write telemetry metrics (schema'd JSONL; one "
                         "file a rank when k > 1)")
    ap.add_argument("--trace-out", default=None, metavar="JSON",
                    help="write host-side spans as Chrome-trace/Perfetto "
                         "JSON (one file a rank when k > 1)")
    ap.add_argument("--no-profile", action="store_true",
                    help="disable per-program cost attribution "
                         "(profile/* and compile/* gauges); same as "
                         "REPRO_TELEMETRY_PROFILE=0")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "flash", "ref", "blockwise"],
                    help="a decoder's attention: the flash kernels, the "
                         "einsum ref oracles, or auto (flash on the card, "
                         "ref on the CPU); default: the config's (flash)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.attn_impl == "blockwise":
        ap.error("--attn-impl blockwise: the JAX package's blockwise "
                 "attention scan is not ported (ROADMAP queue 1 item 5); "
                 "use flash, ref or auto")
    try:
        plan_from_opts(vars(args))
    except ValueError as e:
        ap.error(str(e))
    if is_elastic(vars(args)):
        if args.algo not in ("easgd", "asgd"):
            ap.error("--quorum/--fault-plan need an async plan (--algo "
                     "easgd|asgd); bsp fault tolerance is checkpoint "
                     "restart via --ckpt/--resume")
        if args.preset or args.pods > 1:
            ap.error("--quorum/--fault-plan train one plan over one level "
                     "of slots (no --preset, no --pods)")
        if (args.workers or args.ranks) > args.ranks:
            ap.error(f"--workers {args.workers} > --ranks {args.ranks} "
                     f"slots")
    if args.pods < 1 or args.ranks % args.pods:
        ap.error(f"--ranks {args.ranks} do not split into --pods "
                 f"{args.pods}")
    if args.preset in PRESET_BATCH:
        batch, args.seq = PRESET_BATCH[args.preset]
        args.batch = args.batch or batch
    if args.batch is None:
        args.batch = (LM_BATCH if args.preset else
                      CONV_BATCH.get(args.arch, LM_BATCH))
    for out in (args.metrics_out, args.trace_out):
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    dev = default_device(args.device)
    backend = pick_backend(dev, args.ranks)
    opts = dict(vars(args), device=str(dev))
    with tempfile.TemporaryDirectory() as data_dir:
        run_ranks(_train_rank, args.ranks, (opts, backend, data_dir),
                  backend=backend)


if __name__ == "__main__":
    main()
