#!/usr/bin/env bash
# The sampler check of chip_smoke.py in two trees on one card, in the order
# parent, change, change, parent: slot_gather_sample held bit for bit to its
# plain version and timed (CUDA-graph replay, L2 flushed; and the wrapper's
# host time) at the four serve shapes, the decode's (8, 1, V) and the
# prefill tail's (1, 32, V) at vocab 128,256 and 151,936. Then, in the
# change tree alone, the same check with the plan's cluster size forced to
# 4, 8 and 16 blocks a slot (each with its own slice), in three rounds
# taken in turn, beside the clusters of each size that the card holds at
# once.
#
#   bash tools/ab_sampler.sh PARENT_DIR [CHANGE_DIR]
#
# PARENT_DIR is a checkout of the commit to compare against (for example
# `git archive HEAD~1 | tar -x -C _dev/parent`); CHANGE_DIR defaults to the
# current directory. Each line is tagged with its tree.
set -u
parent=${1:?usage: ab_sampler.sh PARENT_DIR [CHANGE_DIR]}
change=${2:-.}
build='import sys; sys.path[:0] = ["src"]; from repro_torch import kernels as K; K.build_all(("slot_gather",))'
run() {  # tree label [sweep]
  (cd "$1" && python3 -c "
import json, sys
sys.path[:0] = ['src', 'tests']
import torch
import chip_smoke as cs
from repro_torch.kernels import ref
from repro_torch.kernels import slot_gather as sg
l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
keys = ('ms', 'host_ms', 'library_ms', 'plain_ms')


def check(tag):
    g = torch.Generator(device='cuda').manual_seed(1234)
    for V in (128256, 151936):
        for S, C in ((8, 1), (1, 32)):
            r = cs._sampler_check(torch, ref, sg, g, S, C, V, l2.zero_)
            print('sampler ' + json.dumps(dict(
                shape=[S, C, V], **tag, **{k: r[k] for k in keys})))


check({})
if '${3:-}' == 'sweep':
    print('sampler clusters at once ' + json.dumps(
        {cl: sg.clusters_at_once(cl) for cl in (4, 8, 16)}))
    for rnd in range(3):
        for cl in (4, 8, 16):
            def forced(S, C, V, sm_count, cl=cl):
                sl = -(-V // cl)
                sl += -sl % sg.SAMPLER_VEC
                return -(-V // sl), sl
            sg.sampler_plan = forced
            check({'forced_cl': cl, 'round': rnd})
" 2>&1 | grep -E "^sampler |FAILED|Error" | sed "s/^/[$2] /")
}
(cd "$parent" && python3 -c "$build") &
(cd "$change" && python3 -c "$build") &
wait
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$parent" parent1; run "$change" change1; run "$change" change2 sweep
run "$parent" parent2
