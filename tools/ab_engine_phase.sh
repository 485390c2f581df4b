#!/usr/bin/env bash
# The engine phase of chip_smoke.py (full llama3.2-1b and full qwen1.5-4b,
# bf16, paged KV, 16 requests) in two trees on one card, in the order
# parent, change, change, parent, so that the card's drift falls on both
# sides alike.
#
#   bash tools/ab_engine_phase.sh PARENT_DIR [CHANGE_DIR]
#
# PARENT_DIR is a checkout of the commit to compare against (for example
# `git archive HEAD~1 | tar -x -C _dev/parent`); CHANGE_DIR defaults to
# the current directory. Both trees' kernels are built first, side by
# side. Each run prints, tagged with its tree:
# - the "engine" line of chip_smoke.engine_phase (decode tokens/s, p50/p99
#   per-token latency in token_latency_ms, ...; the flash-vs-einsum logit
#   check is left to chip_smoke.py itself);
# - a "decode step" line: one decode step of the model (8 slots at the
#   serve positions, pages of 16), its host wall time untraced (median of
#   20, ending in a synchronize) and the device operations it launches
#   (kernels, copies and sets, counted by torch.profiler over 4 steps);
#   and the host time of one flash_decode_paged call at the model's heads
#   (the mean over 1000 calls enqueued back to back, in microseconds).
set -u
parent=${1:?usage: ab_engine_phase.sh PARENT_DIR [CHANGE_DIR]}
change=${2:-.}
build='import sys; sys.path[:0] = ["src"]; from repro_torch import kernels as K; K.build_all()'
run() {  # tree label
  (cd "$1" && python3 -c "
import json, sys, time
sys.path[:0] = ['src', 'tests']
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch import configs, models, serve
from repro_torch import kernels as K
from repro_torch.kernels import flash_attention as fa
K.build_all()
cs.check_flash_vs_ref = lambda *a, **k: None
dev = torch.device('cuda')
for arch in ('llama3.2-1b', 'qwen1.5-4b'):
    cfg = configs.get_config(arch)
    cs.engine_phase(torch, K, cfg, models, serve, dev)
    torch.cuda.empty_cache()
    model = models.build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    B, ps, NP = 8, 16, 64
    pool = model.init_paged_cache(B, ps, B * NP + 1)
    tables = (torch.arange(B * NP, dtype=torch.int32, device=dev) + 1
              ).reshape(B, NP)
    pos = torch.tensor([64, 200, 333, 480, 512, 700, 871, 1000], device=dev)
    tok = {'tokens': torch.zeros(B, 1, dtype=torch.int64, device=dev)}
    step = lambda: model.decode_step(params, pool, tok, pos, seq_len=1024,
                                     block_tables=tables, page_size=ps)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(20):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            step()
        torch.cuda.synchronize()
    ops = sum(1 for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA)
    a = cfg.attention
    qd = torch.zeros(B, 1, a.num_heads, a.head_dim, dtype=torch.bfloat16,
                     device=dev)
    kp = torch.zeros(B * NP + 1, ps, a.num_kv_heads, a.head_dim,
                     dtype=torch.bfloat16, device=dev)
    pos32 = pos.to(torch.int32)
    call = lambda: fa.flash_decode_paged(qd, kp, kp, tables, pos32,
                                         page_size=ps)
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        call()
    call_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print('decode step ' + json.dumps({
        'arch': arch, 'host_ms_p50': sorted(wall)[len(wall) // 2],
        'device_ops_per_step': ops / 4,
        'paged_decode_call_host_us': call_us}))
    del model, params, pool
    torch.cuda.empty_cache()
" 2>&1 | grep -E "^engine |^decode step|FAILED|Error" | sed "s/^/[$2] /" | cut -c1-900)
}
(cd "$parent" && python3 -c "$build") &
(cd "$change" && python3 -c "$build") &
wait
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$parent" parent1; run "$change" change1; run "$change" change2
run "$parent" parent2
