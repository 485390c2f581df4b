"""Checkpointing: a state tree <-> a directory of .npz files, crash-safe
(counterpart of ``repro/checkpoint/ckpt.py``, with the same on-disk
contract, so either package reads what the other wrote):

- ``state-<step>.npz`` holds the tree flattened to '/'-joined keys (dict
  keys, list positions); bf16 is stored as fp32 (npz has no bf16) and
  cast back on restore; ``meta-<step>.json`` records the step, the keys,
  the file, its crc32 ``checksum`` and ``nbytes``, and the algorithm;
- every file is written to a temp file, fsynced and ``os.replace``d into
  place, so a kill at any instant leaves the old file or the new one;
  ``meta.json`` (the latest pointer) is written last;
- restore verifies the checksum and falls back, with a warning, to the
  newest step that passes it when the latest is torn or missing;
- the newest ``keep`` steps are retained.

Restore rebuilds the structure, dtypes and devices of a ``state_like``
tree; a non-tensor leaf (the ``step`` counter) comes back as an int.

Ranks: in a run of k > 1 ranks every rank writes its own whole state to
``<path>/rank<r>/`` (:func:`rank_dir`), the replicated parameters
included, so the sharded update's per-rank master and optimizer shards
restore without a collective; such a run resumes on the same k. A run of
one rank writes ``<path>`` itself: the JAX package's layout.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import warnings
import zlib

import numpy as np
import torch


def rank_dir(path: str, rank: int, k: int) -> str:
    """The directory that rank ``rank`` of ``k`` checkpoints into."""
    return path if k <= 1 else os.path.join(path, f"rank{rank}")


def _flatten(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:       # npz has no bf16: store fp32
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _atomic_write(path: str, data: bytes) -> None:
    """Write to a temp file in the target directory, fsync, rename."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _state_name(step: int) -> str:
    return f"state-{step:08d}.npz"


def _meta_name(step: int) -> str:
    return f"meta-{step:08d}.json"


def save_checkpoint(path: str, state, step: int | None = None,
                    algo: str | None = None, keep: int = 3) -> None:
    """Crash-safe save of ``state`` at ``step`` into directory ``path``:
    the state file and its per-step meta, then the ``meta.json`` latest
    pointer; keeps the newest ``keep`` steps."""
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(state).items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    step_i = int(step) if step is not None else 0
    meta = {"step": step_i, "keys": sorted(arrays), "file": _state_name(step_i),
            "checksum": zlib.crc32(data), "nbytes": len(data)}
    if algo is not None:
        meta["algo"] = algo
    meta_bytes = json.dumps(meta).encode()
    _atomic_write(os.path.join(path, _state_name(step_i)), data)
    _atomic_write(os.path.join(path, _meta_name(step_i)), meta_bytes)
    # the latest pointer last: a crash before it leaves the previous one
    # intact and the new step findable by the fallback scan
    _atomic_write(os.path.join(path, "meta.json"), meta_bytes)
    if keep and keep > 0:
        for s in _saved_steps(path)[:-keep]:
            for name in (_state_name(s), _meta_name(s)):
                try:
                    os.unlink(os.path.join(path, name))
                except OSError:
                    pass


def _saved_steps(path: str) -> list[int]:
    """Steps with a per-step meta present, ascending."""
    try:
        names = os.listdir(path)
    except OSError:
        return []
    steps = []
    for n in names:
        if n.startswith("meta-") and n.endswith(".json"):
            try:
                steps.append(int(n[len("meta-"):-len(".json")]))
            except ValueError:
                pass
    return sorted(steps)


def _verify(path: str, meta: dict) -> bytes | None:
    """The npz bytes if the recorded file exists and matches its crc32
    and size, else None."""
    fn = meta.get("file")
    if not fn:
        return None
    try:
        with open(os.path.join(path, fn), "rb") as f:
            data = f.read()
    except OSError:
        return None
    if "checksum" in meta and zlib.crc32(data) != meta["checksum"]:
        return None
    if "nbytes" in meta and len(data) != meta["nbytes"]:
        return None
    return data


def _load_valid(path: str):
    """(npz, meta) of the newest checkpoint that passes its integrity
    check, falling back step by step."""
    tried = []
    for s in reversed(_saved_steps(path)):
        try:
            with open(os.path.join(path, _meta_name(s))) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            tried.append(s)
            continue
        data = _verify(path, meta)
        if data is None:
            tried.append(s)
            continue
        if tried:
            warnings.warn(
                f"checkpoint {path!r}: step(s) {tried} truncated or "
                f"corrupt; falling back to newest valid step {s}",
                RuntimeWarning, stacklevel=3)
        return np.load(io.BytesIO(data), allow_pickle=False), meta
    raise FileNotFoundError(
        f"no valid checkpoint under {path!r}"
        + (f" (step(s) {tried} failed their integrity check)" if tried
           else ""))


def _restore_tree(data, state_like):
    flat_like = _flatten(state_like)
    missing = set(flat_like) - set(data.files)
    extra = set(data.files) - set(flat_like)
    if missing or extra:
        raise ValueError(
            f"checkpoint layout mismatch (written by a different plan or "
            f"rank count?): missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}")

    def leaf(key, like):
        arr = data[key]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(like.dtype).to(
                like.device)
        return type(like)(arr.item()) if np.ndim(arr) == 0 else arr

    def rebuild(prefix, node):
        if isinstance(node, dict):
            return {k: rebuild(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seq = [rebuild(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(seq)
        return leaf(prefix, node)

    return rebuild("", state_like)


def restore_checkpoint(path: str, state_like):
    """``state_like``'s structure, dtypes and devices, restored from the
    newest valid checkpoint under ``path``."""
    data, _ = _load_valid(path)
    return _restore_tree(data, state_like)


def load_meta(path: str) -> dict:
    """Meta of the newest valid checkpoint (falls back as restore does)."""
    return _load_valid(path)[1]


def latest_step(path: str) -> int:
    return load_meta(path)["step"]


def restore_for_resume(path: str, state_like, expect_algo: str | None = None):
    """Restore ``state_like``'s layout from ``path`` and return ``(state,
    start_step)``. ``expect_algo`` refuses a checkpoint written by another
    algorithm; the meta's step is cross-checked against ``state["step"]``
    (the loop keys data and dropout to the global step). The state and the
    step come from the same verified checkpoint, after any fallback."""
    data, meta = _load_valid(path)
    recorded = meta.get("algo")
    if (expect_algo is not None and recorded is not None
            and recorded != expect_algo):
        raise ValueError(
            f"checkpoint algo mismatch: {path!r} was written by a "
            f"{recorded!r} plan, cannot resume as {expect_algo!r}")
    state = _restore_tree(data, state_like)
    step = int(meta.get("step", 0))
    if isinstance(state, dict) and "step" in state:
        in_state = int(np.asarray(state["step"]))
        if in_state != step:
            raise ValueError(
                f"checkpoint step mismatch: meta.json says {step} but "
                f"state['step'] is {in_state} ({path!r})")
    return state, step
