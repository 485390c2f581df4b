"""Training launcher: the paper's BSP training of AlexNet on k ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --ranks 2 --exchanger asa16 --sharded-update --batch 128 --steps 20

    # on the CPU, with the kernels' plain versions (a smoke-sized AlexNet):
    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --smoke --device cpu --ranks 2 --batch 8 --steps 5

Starts k rank processes (``torch.multiprocessing``, spawn), each joining
one process group through a file rendezvous in a temporary directory.
The backend is NCCL when every rank has a card of its own, else gloo; on
a host with one card all k ranks share ``cuda:0`` over gloo (NCCL refuses
two ranks on one device), and the exchanger stages each collective
through pinned host memory. The NCCL arm is not exercised by any test of
this repository (it needs k cards).

Each rank reads its own share of every global batch (``batch`` images)
from batch files of ``ImageSource`` images at ``image_size + 8`` pixels,
which the ``ParallelLoader`` crops to ``image_size`` (the JAX example
crops to ``image_size - 8``, which its full-size AlexNet cannot take).
Momentum SGD 0.9 with weight decay 5e-4 and the paper's AlexNet LR
policy (/10 every third of the run). Convolutions and matmuls run in
full fp32 (TF32 off), as the reference computes them.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import default_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.prefetch import ParallelLoader
from repro_torch.data.synthetic import ImageSource
from repro_torch.kernels import fused_sgd as fs
from repro_torch.models import build_model, count_params
from repro_torch.optim import sgd_momentum, step_decay
from repro_torch.train.engine import TrainPlan
from repro_torch.train.loop import train

CROP_MARGIN = 8


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


def write_rank_batches(cfg, rank: int, k: int, batch: int, count: int,
                       out_dir: str) -> list[str]:
    """``count`` batch files of this rank's share: file j holds
    ``ImageSource(image_size + 8).batch(batch, j * k + rank)``."""
    src = ImageSource(cfg.image_size + CROP_MARGIN, cfg.num_classes)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for j in range(count):
        path = os.path.join(out_dir, f"rank{rank}_batch_{j:05d}.npz")
        np.savez(path, **src.batch(batch, j * k + rank))
        paths.append(path)
    return paths


def rank_loader(cfg, files, device, steps: int, seed: int):
    mean = np.zeros((cfg.image_size + CROP_MARGIN,) * 2 + (3,), np.float32)
    return ParallelLoader(files, image_mean=mean, crop=cfg.image_size,
                          depth=2, device=device, seed=seed,
                          epochs=-(-steps // len(files)))


def set_fp32_math() -> None:
    """Full fp32 convolutions and matmuls (PyTorch lets cuDNN use TF32
    for fp32 convolutions by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _train_rank(rank, k, opts, backend, data_dir):
    set_fp32_math()
    dev = rank_device(torch.device(opts["device"]), rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = (get_smoke_config if opts["smoke"] else get_config)(opts["arch"])
    model = build_model(cfg, dev)
    files = write_rank_batches(cfg, rank, k, opts["batch"],
                               min(opts["steps"], 8),
                               os.path.join(data_dir, f"rank{rank}"))
    loader = rank_loader(cfg, files, dev, opts["steps"], seed=rank)
    plan = TrainPlan(exchanger=opts["exchanger"], scheme=opts["scheme"],
                     sharded_update=opts["sharded_update"])
    opt = sgd_momentum(momentum=0.9, weight_decay=5e-4,
                       fused_kernel=fs.fused_sgd)
    lr = step_decay(0.01, steps_per_drop=max(opts["steps"] // 3, 1))
    try:
        state, report = train(model, opt, lr, loader, plan=plan,
                              num_steps=opts["steps"], log_every=5,
                              print_fn=print if rank == 0 else
                              (lambda *a: None))
    finally:
        loader.stop()
    if rank == 0:
        n = count_params(state["params"])
        split = ", ".join(f"{p} {s * 1e3:.1f} ms"
                          for p, s in report.phase_s.items())
        print(f"done: {report.steps} steps of {cfg.name} ({n:,} params) on "
              f"{k} ranks ({backend}, {dev}), {plan.exchanger}"
              f"{' sharded' if plan.sharded_update else ''}: "
              f"{report.steady_examples_per_s:.1f} images/s steady "
              f"(first step {report.first_step_time:.2f} s; per step "
              f"{split}), loss {report.losses[0]:.4f} -> "
              f"{report.losses[-1]:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="alexnet", choices=["alexnet"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (96 px, 16 classes)")
    ap.add_argument("--exchanger", default="asa16",
                    help="ar | asa | asa16 | asabf16 | asa8 | none")
    ap.add_argument("--scheme", default="subgd", choices=["subgd", "awagd"])
    ap.add_argument("--sharded-update", action="store_true",
                    help="RS -> update -> AG on this rank's 1/k shard")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=128,
                    help="images per rank and step")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    try:
        TrainPlan(exchanger=args.exchanger, scheme=args.scheme,
                  sharded_update=args.sharded_update)
    except ValueError as e:
        ap.error(str(e))
    dev = default_device(args.device)
    backend = pick_backend(dev, args.ranks)
    opts = dict(vars(args), device=str(dev))
    with tempfile.TemporaryDirectory() as data_dir:
        run_ranks(_train_rank, args.ranks, (opts, backend, data_dir),
                  backend=backend)


if __name__ == "__main__":
    main()
