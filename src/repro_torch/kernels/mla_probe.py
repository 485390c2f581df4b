"""A short first call for the flash kernels' MLA route on the card: build
``csrc/flash_attention.cu``, print the registers and spills (``ptxas -v``)
of the CUDA-core forward, dq and dk/dv and of the bf16/fp16 forward and
backward on the tensor cores (``fwd_mla_hopper``, ``bwd_dq_mla_hopper``,
``bwd_dkv_mla_hopper``, ``mla_dkv_reduce``), hold each MLA-route entry
to its plain version at a few shapes (fp32, bf16 and fp16; Dk != Dv; a
padded pair; G up to 16, G 12 with spare rows; KV 2; windows, ragged
ends, a q offset with Sq < Sk; two forward and two backward calls
bitwise equal), then time the three at DeepSeek-V2-Lite's training shape
(B 2, S 1024, 16 heads over 1, Dk 576, Dv 512, bf16) with CUDA events
over 5 calls, the L2 cache left warm (``chip_smoke.py`` phase 11 times
them from a CUDA graph with the L2 flushed).

    PYTHONPATH=src python -m repro_torch.kernels.mla_probe

Run from the root of a checkout on a machine with the card and the CUDA
toolkit (about a minute, most of it the build).
"""
import math
import re
import time

import torch

from repro_torch import kernels as K
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def build_report():
    t0 = time.time()
    K.build_all(("flash_attention",))
    print(f"build {time.time() - t0:.1f}s")
    entry = None
    for line in K.build_log("flash_attention").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        if entry and re.search(r"(fwd|bwd_dq|bwd_dkv)_kernel|mla_hopper|"
                               r"mla_dkv_reduce", entry) and (
                "registers" in line or "spill" in line):
            print(entry[:60], line.strip())


FAILED = []
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}


def check_fwd(dtype, B, Sq, Sk, H, KV, Dk, Dv, win=0, off=0, seed=0):
    """The forward alone (out, lse) against plain at Sq != Sk, and two
    calls bitwise equal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    q, k, v = rn(B, Sq, H, Dk), rn(B, Sk, KV, Dk), rn(B, Sk, KV, Dv)
    qo = fa._positions(off, B, q.device)
    sc = 1 / math.sqrt(Dk)
    out, lse = fa.flash_attention(q, k, v, q_off=qo, window=win, sm_scale=sc,
                                  return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, qo, win, sc, True)
    again = fa.flash_attention(q, k, v, q_off=qo, window=win, sm_scale=sc,
                               return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    print(str(dtype)[6:], "fwd", (B, Sq, Sk, H, KV, Dk, Dv, win, off), "out",
          err, "lse", err_l, "bitwise", same)
    if not (err <= FWD_TOL[dtype] and err_l <= 1e-3 and same):
        FAILED.append(f"forward at {dtype} {(B, Sq, Sk, H, KV, Dk, Dv, win)}")


def check(dtype, B, S, H, KV, Dk, Dv, win=0, off=0, seed=0):
    """The forward (out, lse), dq and dk/dv against plain; returns the
    inputs the timing reuses."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    q, k, v, do = rn(B, S, H, Dk), rn(B, S, KV, Dk), rn(B, S, KV, Dv), \
        rn(B, S, H, Dv)
    qo = fa._positions(off, B, q.device)
    sc = 1 / math.sqrt(Dk)
    kw = dict(q_off=qo, window=win, sm_scale=sc)
    K.reset_launches()
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    want, want_lse = ref.flash_attention_ref(q, k, v, qo, win, sc, True)
    di = ref.flash_attention_di(out, do)
    dq = fa.flash_attention_dq(q, k, v, lse, do, di, **kw)
    dk, dv = fa.flash_attention_dkv(q, k, v, lse, do, di, **kw)
    wq = ref.flash_attention_dq_ref(q, k, v, lse, do, di, qo, win, sc)
    wk, wv = ref.flash_attention_dkv_ref(q, k, v, lse, do, di, qo, win, sc)
    torch.cuda.synchronize()
    rel = lambda a, b: ((a.float() - b.float()).abs().max()  # noqa: E731
                        / b.float().abs().max()).item()
    print(str(dtype)[6:], (B, S, H, KV, Dk, Dv, win), "out",
          (out.float() - want.float()).abs().max().item(), "lse",
          (lse - want_lse).abs().max().item(), "dq", rel(dq, wq), "dk",
          rel(dk, wk), "dv", rel(dv, wv), dict(K.LAUNCHES))
    err = (out.float() - want.float()).abs().max().item()
    if not (err <= FWD_TOL[dtype] and (lse - want_lse).abs().max() <= 1e-3):
        FAILED.append(f"forward off its plain version at {dtype} "
                      f"{(B, S, H, KV, Dk, Dv, win)}")
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    if not max(rel(dq, wq), rel(dk, wk), rel(dv, wv)) <= tol:
        FAILED.append(f"backward off its plain version at {dtype} "
                      f"{(B, S, H, KV, Dk, Dv, win)}")
    again = (fa.flash_attention_dq(q, k, v, lse, do, di, **kw),
             *fa.flash_attention_dkv(q, k, v, lse, do, di, **kw))
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        FAILED.append(f"two backward calls differ at {dtype} "
                      f"{(B, S, H, KV, Dk, Dv, win)}")
    return q, k, v, do, qo, sc, lse, di


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mla_probe: no CUDA device visible")
    build_report()
    check(torch.float32, 1, 100, 8, 2, 64, 64, 33, [7])     # the fp32 path
    check(torch.float32, 1, 128, 8, 2, 128, 128)
    check(torch.float32, 2, 100, 4, 1, 80, 64, 7, [0, 5])   # the MLA route
    check(torch.bfloat16, 2, 100, 4, 1, 80, 64, 0, [0, 5])
    check(torch.bfloat16, 2, 100, 8, 2, 80, 64, 7)
    check(torch.bfloat16, 1, 100, 8, 2, 192, 192)
    check(torch.float16, 2, 100, 4, 1, 80, 64, 0, [0, 5])
    check(torch.bfloat16, 1, 77, 8, 2, 80, 64, 7, [3])      # KV 2, ragged
    check(torch.bfloat16, 1, 200, 16, 1, 576, 512)
    check(torch.float16, 2, 129, 16, 1, 576, 512, 50, [0, 9])
    check(torch.bfloat16, 1, 100, 12, 4, 300, 200, 0, [5])  # G 3, padded
    check(torch.bfloat16, 2, 1000, 16, 1, 576, 512, 300)
    check(torch.float32, 1, 200, 16, 1, 576, 512)
    for dtype in (torch.bfloat16, torch.float16):
        check_fwd(dtype, 2, 1024, 1024, 16, 1, 576, 512)
        check_fwd(dtype, 2, 1000, 1000, 16, 1, 576, 512, 300)
        check_fwd(dtype, 1, 200, 200, 24, 2, 576, 512, 0, 0)   # G 12
        check_fwd(dtype, 2, 100, 300, 16, 1, 576, 512, 0, [200, 150])
        check_fwd(dtype, 2, 70, 333, 12, 1, 576, 512, 64, [263, 40])
        check_fwd(dtype, 2, 100, 100, 4, 1, 80, 64, 7, [0, 5])
    q, k, v, do, qo, sc, lse, di = check(torch.bfloat16, 2, 1024, 16, 1,
                                         576, 512)
    kw = dict(q_off=qo, sm_scale=sc)
    for name, fn in (
            ("fwd", lambda: fa.flash_attention(q, k, v, return_lse=True,
                                               **kw)),
            ("dq", lambda: fa.flash_attention_dq(q, k, v, lse, do, di, **kw)),
            ("dkv", lambda: fa.flash_attention_dkv(q, k, v, lse, do, di,
                                                   **kw))):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(5):
            fn()
        e.record()
        e.synchronize()
        print(name, "ms", s.elapsed_time(e) / 5)
    if FAILED:
        raise SystemExit("mla_probe: FAILED: " + "; ".join(FAILED))


if __name__ == "__main__":
    main()
