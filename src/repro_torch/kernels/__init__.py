"""Hand-written Hopper kernels: build, load and launch bookkeeping.

Every kernel lives in ``src/repro_torch/csrc/<name>.cu`` behind a plain C
interface (pointers and the stream as ``void*``, sizes as ``int``; each
entry point returns ``cudaGetLastError()``). :func:`load` compiles a
source with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first use
and loads it with ``ctypes``; :func:`build_all` starts one ``nvcc`` per
source at once. Nothing is compiled or loaded at import, so the CPU
tests import every module on a host with no CUDA toolkit.

Each Python wrapper takes its plain PyTorch version (``kernels/ref.py``)
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. The wrappers that the dry run's programs reach
(``launch/dryrun.py``) also take tensors on the ``meta`` device: they
return the kernel's outputs as meta tensors of its shapes and dtypes and
report its cost, and launch nothing (:func:`on_meta`); the others raise
on meta tensors. A wrapper counts its launches in :data:`LAUNCHES` so a run can
show that a path went through the kernel, and reports each launch's
flops and bytes through :func:`cost` so a program's cost count
(``roofline.analysis.CostMode``) includes the kernels.

Built without ``--use_fast_math``: the sampling kernel's ``row / T +
noise`` must round exactly as the plain version's IEEE division does.
Built with ``ptxas -v``: :func:`build_log` returns each kernel's
registers, shared memory and spills from the build.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "slot_gather", "exchange", "sgd")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points per source: argument types (every one returns int)
SIGNATURES = {
    "flash_attention": {
        "flash_fwd": [_P] * 6 + [_I] * 8 + [_F, _P],
        "flash_bwd_dq": [_P] * 8 + [_I] * 8 + [_F, _P],
        "flash_bwd_dkv": [_P] * 9 + [_I] * 8 + [_F, _P],
        "flash_decode_split": [_P] * 8 + [_I] * 12 + [_F, _P],
        "flash_decode_combine": [_P] * 5 + [_I] * 9 + [_P],
        "flash_mla_fwd": [_P] * 6 + [_I] * 9 + [_F, _P],
        "flash_mla_bwd_dq": [_P] * 8 + [_I] * 9 + [_F, _P],
        "flash_mla_bwd_dkv": [_P] * 9 + [_I] * 9 + [_F, _P, _I, _P],
        "flash_mla_dkv_reduce": [_P] * 4 + [_I] * 10 + [_P],
    },
    "slot_gather": {
        "slot_gather_sample": [_P] * 6 + [_I] * 6 + [_P],
        "slot_gather_max_clusters": [_I, _P],
    },
    "exchange": {
        "chunk_sum": [_P, _P, _I, _L, _I, _P],
        "quant_fp16": [_P, _P, _L, _P],
        "dequant_fp16": [_P, _P, _L, _P],
        "quant_int8": [_P, _P, _P, _L, _I, _P],
        "dequant_int8": [_P, _P, _P, _L, _I, _P],
    },
    "sgd": {
        "fused_sgd": [_P] * 6 + [_L, _F, _I, _P],
        "fused_rs_update": [_P] * 8 + [_I, _L, _I, _F, _F, _F, _I, _P],
    },
}

# launches per wrapper name; the wrappers add one where they launch
LAUNCHES: dict[str, int] = {}
# the same per (name, shape) for the wrappers that pass their shape, so a
# run can split one kernel's launches over the shapes a path gave it
LAUNCH_SHAPES: dict[tuple[str, tuple[int, ...]], int] = {}

# the active cost counters (``roofline.analysis.CostMode``), innermost last
cost_sinks: list = []

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count(name: str, shape: tuple[int, ...] | None = None) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    if shape is not None:
        key = (name, tuple(shape))
        LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


def cost(name: str, work) -> None:
    """Report one launch's work to the innermost active ``CostMode``,
    which cannot see a ``ctypes`` launch: ``work()`` returns (flops, bytes
    read plus written) and is called only when a mode is active, so a
    cost that reads a device value (a decode's positions) syncs nothing
    and no launch pays for its cost otherwise."""
    if cost_sinks:
        flops, nbytes = work()
        cost_sinks[-1].add_kernel(name, float(flops), float(nbytes))


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    """Library path keyed by the source's content and the flags, so an
    edited source never loads a stale build."""
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def _compile(name: str):
    """Start ``nvcc`` for one source; returns (Popen or None, target)."""
    out = _target(name)
    if out.exists():
        return None, out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return proc, out


def _finish(name: str, proc, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(proc.tmp, out)        # atomic: a reader never sees half a .so


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every source in parallel (one ``nvcc`` each, all started
    together). Returns {name: library path}."""
    started = {n: _compile(n) for n in names}
    for n, (proc, out) in started.items():
        _finish(n, proc, out)
    return {n: out for n, (_, out) in started.items()}


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``csrc/<name>.cu``
    (``ptxas -v``: registers, shared memory, spills per kernel); empty
    before the first build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass_ops(name: str, pattern: str,
             ops=("HGMMA", "UTMALDG")) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {op: count, ..., "atomics": count}} for each
    kernel of the current build of ``csrc/<name>.cu`` whose mangled name
    matches ``pattern``, counted in ``cuobjdump -sass`` (atomics: ATOM*
    and RED). Needs the CUDA toolkit and a build."""
    sass = subprocess.run(
        [str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
         str(_target(name))], capture_output=True, text=True,
        timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            fn = fn if re.search(pattern, fn) else None
            if fn:
                out[fn] = dict.fromkeys((*ops, "atomics"), 0)
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if fn and m:
            op = m.group(1)
            if op in ops:
                out[fn][op] += 1
            elif op.startswith("ATOM") or op == "RED":
                out[fn]["atomics"] += 1
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            proc, out = _compile(name)
            _finish(name, proc, out)
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (the plans size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# the H100 SXM's SMs: the plans that size grids by the SM count take this
# for meta tensors, which have no card to ask
META_SM_COUNT = 132
# the position the cost functions read for a meta position tensor, which
# holds no values (:func:`meta_positions`)
_meta_pos = [0]


@contextlib.contextmanager
def meta_positions(pos: int):
    """Within the block, every position tensor on the meta device (a
    decode's slot positions, a flash call's q_off) stands for ``pos`` in
    every row; 0 outside any block."""
    prev = _meta_pos[0]
    _meta_pos[0] = int(pos)
    try:
        yield
    finally:
        _meta_pos[0] = prev


def meta_position() -> int:
    return _meta_pos[0]


def plain_path(*ts: torch.Tensor) -> bool:
    """Dispatch of a wrapper with a meta path: all-meta tensors take the
    launch path, which launches nothing on them (:func:`launches`);
    otherwise :func:`on_cpu`."""
    present = [t for t in ts if t is not None]
    if present and all(t.is_meta for t in present):
        return False
    return on_cpu(*ts)


def launches(t: torch.Tensor) -> bool:
    """Whether a wrapper on its launch path launches for ``t``: on the
    card, yes; on the meta device (the dry run) it allocates its outputs
    and reports its cost as on the card, and launches and counts
    nothing."""
    return not t.is_meta


def sms_of(t: torch.Tensor) -> int:
    """The SMs a plan sizes its grid by: the card's (:func:`sm_count`),
    :data:`META_SM_COUNT` for a meta tensor."""
    return META_SM_COUNT if t.is_meta else sm_count(t.device.index or 0)


def on_cpu(*ts: torch.Tensor) -> bool:
    """Plain-version dispatch: True iff every tensor lies on the CPU. A
    mix of devices, or a device other than CPU/CUDA, raises."""
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(devs)}: the kernels take all-CPU "
                     f"(plain version) or all-CUDA inputs")


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3}


def dtype_code(t: torch.Tensor, allowed=(torch.float32, torch.bfloat16,
                                         torch.float16)) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"kernel takes {'/'.join(str(d)[6:] for d in allowed)}"
                        f", got {t.dtype}")
    return DTYPE_CODE[t.dtype]
