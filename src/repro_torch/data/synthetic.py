"""Synthetic data sources (deterministic, seeded) for LM and image
training, plus on-disk batch files for the parallel loader (the paper
stores ImageNet as batch files on disk, Alg. 1). A numpy copy of
``repro/data/synthetic.py``, pinned to it by ``tests/test_torch_train.py``.
"""
from __future__ import annotations

import os

import numpy as np


class LMTokenSource:
    """Deterministic pseudo-corpus: Zipfian tokens with a learnable bigram
    structure so small models show decreasing loss."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.rng = np.random.default_rng(seed)
        # low-rank bigram transition: next ~ (cur * a + b) mod V with noise
        self.a = int(self.rng.integers(2, 7))
        self.b = int(self.rng.integers(1, vocab_size))

    def batch(self, batch_size: int, step: int):
        rng = np.random.default_rng((step + 1) * 7919)
        first = rng.integers(0, self.vocab, (batch_size, 1))
        toks = [first]
        cur = first
        for _ in range(self.seq):
            nxt = (cur * self.a + self.b) % self.vocab
            noise = rng.integers(0, self.vocab, cur.shape)
            mask = rng.random(cur.shape) < 0.1
            cur = np.where(mask, noise, nxt)
            toks.append(cur)
        seq = np.concatenate(toks, axis=1)  # (B, S+1)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}


class ImageSource:
    """Synthetic class-conditional images (separable Gaussian blobs)."""

    def __init__(self, image_size: int, num_classes: int, seed: int = 0):
        self.size = image_size
        self.classes = num_classes
        rng = np.random.default_rng(seed)
        self.proto = rng.normal(0, 1, (num_classes, 8, 8, 3)).astype(np.float32)

    def batch(self, batch_size: int, step: int):
        rng = np.random.default_rng((step + 1) * 104729)
        labels = rng.integers(0, self.classes, (batch_size,))
        base = self.proto[labels]
        reps = self.size // 8 + 1
        imgs = np.tile(base, (1, reps, reps, 1))[:, :self.size, :self.size, :]
        imgs = imgs + rng.normal(0, 0.5, imgs.shape).astype(np.float32)
        return {"images": imgs.astype(np.float32),
                "labels": labels.astype(np.int32)}


def materialize_batch_files(source, out_dir: str, num_batches: int,
                            batch_size: int):
    """Write batches as .npz files on disk (the paper's batch-file layout).
    Returns the list of file paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(num_batches):
        b = source.batch(batch_size, i)
        path = os.path.join(out_dir, f"batch_{i:05d}.npz")
        np.savez(path, **b)
        paths.append(path)
    return paths
