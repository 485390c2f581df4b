"""Parallel loading (paper §3.3, Algorithm 1), counterpart of
``repro/data/prefetch.py``.

Theano-MPI runs a loader beside each trainer that loads a batch file,
preprocesses it (mean-subtract, crop, mirror), copies it to the device
and hands the trainer a ready buffer, all overlapped with the previous
batch's forward and backward. Here a background thread runs that state
machine with a bounded queue ``depth`` batches deep: numpy IO and the
copies release the interpreter lock. On the card each batch is copied
into pinned host memory and sent with a ``non_blocking`` copy on the
loader's own CUDA stream; ``get()`` makes the consumer's stream wait for
that copy, so the trainer never reads a half-copied batch and never
blocks the host on it.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch


def preprocess_images(batch: dict, image_mean, crop: int,
                      rng: np.random.Generator, train: bool = True) -> dict:
    """Alg 1 steps 10-11: mean-subtract, random-crop, mirror."""
    x = batch["images"]
    x = x - image_mean
    H = x.shape[1]
    if crop and crop < H:
        if train:
            oy, ox = rng.integers(0, H - crop + 1, 2)
        else:
            oy = ox = (H - crop) // 2
        x = x[:, oy:oy + crop, ox:ox + crop, :]
        if train and rng.random() < 0.5:
            x = x[:, :, ::-1, :]
    out = dict(batch)
    out["images"] = np.ascontiguousarray(x, np.float32)
    return out


class LoaderError(RuntimeError):
    """A ParallelLoader worker-thread failure, re-raised in the consumer."""


class _Failure:
    """Sentinel carrying the worker thread's exception to ``get()``."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Ready:
    """A batch on its way to the device: tensors, the event that marks the
    end of their copy (None on the CPU), and the pinned host sources,
    kept alive until the copy has ended."""

    def __init__(self, tensors: dict, event, hosts: list):
        self.tensors, self.event, self.hosts = tensors, event, hosts


class ParallelLoader:
    """Background loader thread implementing Alg 1's overlap:
    load(file) -> preprocess -> device, ``depth`` batches ahead of the
    consumer.

    Failure semantics: an exception in the worker thread (missing file,
    corrupt npz, a failed copy) reaches the caller as a
    :class:`LoaderError` from the next ``get()``; ``get()`` waits at most
    ``timeout`` seconds and then raises ``TimeoutError`` saying whether
    the thread stalled or died."""

    def __init__(self, files: list[str], *, image_mean=None, crop: int = 0,
                 depth: int = 2, mode: str = "train", device="cpu",
                 seed: int = 0, epochs: int = 1, io_delay_ms: float = 0.0,
                 timeout: float | None = 120.0):
        self.files = files
        self.image_mean = image_mean
        self.crop = crop
        self.mode = mode
        self.device = torch.device(device)
        self.epochs = epochs
        self.io_delay_ms = io_delay_ms  # simulated remote-disk latency (§3.3)
        self.timeout = timeout
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._ctl: queue.Queue = queue.Queue()
        self._rng = np.random.default_rng(seed)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _to_device(self, raw: dict, stream) -> _Ready:
        if self.device.type != "cuda":
            return _Ready({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in raw.items()}, None, [])
        hosts = [torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                 for v in raw.values()]
        with torch.cuda.stream(stream):
            tensors = {k: h.to(self.device, non_blocking=True)
                       for k, h in zip(raw, hosts)}
            event = torch.cuda.Event()
            event.record(stream)
        return _Ready(tensors, event, hosts)

    # -- loader state machine (Alg 1) ---------------------------------------
    def _run(self):
        try:
            stream = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
            for _ in range(self.epochs):
                for path in self.files:
                    # a mode/stop message (Alg 1 steps 13-17)
                    try:
                        msg = self._ctl.get_nowait()
                        if msg == "stop":
                            self._q.put(None)
                            return
                        self.mode = msg
                    except queue.Empty:
                        pass
                    if self.io_delay_ms:
                        time.sleep(self.io_delay_ms / 1e3)
                    with np.load(path) as f:
                        raw = dict(f)
                    if "images" in raw and self.image_mean is not None:
                        raw = preprocess_images(raw, self.image_mean,
                                                self.crop, self._rng,
                                                train=(self.mode == "train"))
                    # blocks while the queue is full (the double buffer)
                    self._q.put(self._to_device(raw, stream))
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            self._q.put(_Failure(e))
            return
        self._q.put(None)

    # -- consumer API --------------------------------------------------------
    def get(self):
        """Next batch (a dict of tensors on the device), or None at the end
        of the stream. Raises :class:`LoaderError` if the worker thread
        failed, and ``TimeoutError`` after ``timeout`` seconds without a
        batch."""
        try:
            item = self._q.get(timeout=self.timeout)
        except queue.Empty:
            alive = self._thread.is_alive()
            raise TimeoutError(
                f"ParallelLoader.get() waited {self.timeout:.0f}s without a "
                f"batch (loader thread "
                f"{'stalled' if alive else 'died without reporting'}; "
                f"{len(self.files)} files, depth={self._q.maxsize})")
        if isinstance(item, _Failure):
            # terminal: re-queue so later get()/stop() calls also see it
            self._q.put(item)
            raise LoaderError(
                f"ParallelLoader worker thread failed: "
                f"{type(item.exc).__name__}: {item.exc}") from item.exc
        if item is None:
            return None
        if item.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(item.event)
            for t in item.tensors.values():
                t.record_stream(cur)     # the allocator frees after use
        return item.tensors

    def set_mode(self, mode: str):
        self._ctl.put(mode)

    def stop(self):
        self._ctl.put("stop")
        # drain so the thread can observe the message (None and _Failure
        # are both terminal)
        try:
            while not isinstance(self._q.get_nowait(), (type(None),
                                                        _Failure)):
                pass
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __iter__(self):
        while True:
            b = self.get()
            if b is None:
                return
            yield b
