#!/usr/bin/env bash
# The MLA route's forward and tensor-core backward in two trees on one
# card, in the order parent, change, change, parent: at DeepSeek-V2-Lite's
# training shape (B 2, S 1024, 16 heads over 1, Dk 576, Dv 512, bf16) the
# forward (out, lse), dq and dk/dv are held to their plain versions, then
# timed from a CUDA graph with the L2 flushed (chip_smoke._median_ms),
# dk/dv with its reduction.
#
#   bash tools/ab_mla_bwd.sh PARENT_DIR [CHANGE_DIR]
#
# PARENT_DIR is a checkout of the commit to compare against (for example
# `git archive HEAD~1 | tar -x -C _dev/parent`); CHANGE_DIR defaults to the
# current directory. Each line is tagged with its tree.
set -u
parent=${1:?usage: ab_mla_bwd.sh PARENT_DIR [CHANGE_DIR]}
change=${2:-.}
run() {  # tree label
  (cd "$1" && python3 -c "
import json, math, sys
sys.path[:0] = ['src']
import torch
import chip_smoke as cs
from repro_torch import kernels as K
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
K.build_all(('flash_attention',))
B, S, H, KV, Dk, Dv = cs.MLA_SHAPE
g = torch.Generator(device='cuda').manual_seed(31)
rn = lambda *s: torch.randn(*s, generator=g, device='cuda').to(torch.bfloat16)
q, k, v, do = rn(B, S, H, Dk), rn(B, S, KV, Dk), rn(B, S, KV, Dv), rn(B, S, H, Dv)
qo = torch.zeros(B, dtype=torch.int32, device='cuda')
sc = 1 / math.sqrt(Dk)
out, lse = fa.flash_attention(q, k, v, sm_scale=sc, return_lse=True)
want_o, want_l = ref.flash_attention_ref(q, k, v, qo, 0, sc, True)
fwd_err = [(out.float() - want_o.float()).abs().max().item(),
           (lse - want_l).abs().max().item()]
assert fwd_err[0] <= cs.FWD_TOL and fwd_err[1] <= 1e-3, fwd_err
di = ref.flash_attention_di(out, do)
kw = dict(q_off=qo, sm_scale=sc)
got = (fa.flash_attention_dq(q, k, v, lse, do, di, **kw),
       *fa.flash_attention_dkv(q, k, v, lse, do, di, **kw))
want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, qo, 0, sc)
rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
       for a, b in zip(got, want)]
assert max(rel) <= cs.BWD_TOL, rel
l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
ms = {n: cs._median_ms(f, flush=l2.zero_) for n, f in (
    ('fwd', lambda: fa.flash_attention(q, k, v, return_lse=True, **kw)),
    ('dq', lambda: fa.flash_attention_dq(q, k, v, lse, do, di, **kw)),
    ('dkv', lambda: fa.flash_attention_dkv(q, k, v, lse, do, di, **kw)))}
print('mla ' + json.dumps(dict(tree='$2', fwd_err=fwd_err, rel_err=rel,
                                **ms)))
")
}
run "$parent" parent
run "$change" change
run "$change" change
run "$parent" parent
