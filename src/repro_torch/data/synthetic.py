"""Synthetic image, text and tabular datasets and LM token streams
(offline stand-ins), numpy only.

A copy of the generators and of ``lm_token_batches`` of
``repro.data.synthetic``: the same seed gives byte-identical arrays.
Image (CIFAR, Tiny-ImageNet): each class has a low-frequency template (random Fourier features); a sample is the template
times a random contrast, plus a per-class channel bias, Gaussian noise and
a random circular shift.  Text (AG News, SST5): int32 token sequences from
a Zipfian background with class-indicative keywords mixed in.  Tabular
(TOY): Gaussian class blobs under a shared random rotation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.paper import PaperTask


@dataclasses.dataclass(frozen=True)
class SyntheticImageTask:
    num_classes: int
    hw: int = 32
    channels: int = 3
    noise: float = 0.8
    seed: int = 0

    def generate(self, n: int, seed: int | None = None):
        rng = np.random.default_rng(self.seed if seed is None else seed)
        c, hwd = self.num_classes, self.hw
        # low-frequency class templates
        yy, xx = np.meshgrid(np.linspace(0, 1, hwd), np.linspace(0, 1, hwd),
                             indexing="ij")
        templates = np.zeros((c, hwd, hwd, self.channels), np.float32)
        for k in range(c):
            for ch in range(self.channels):
                for _ in range(3):
                    fx, fy = rng.uniform(0.5, 3.0, 2)
                    ph = rng.uniform(0, 2 * np.pi)
                    templates[k, :, :, ch] += np.sin(
                        2 * np.pi * (fx * xx + fy * yy) + ph)
        templates /= np.sqrt((templates ** 2).mean((1, 2, 3), keepdims=True) + 1e-8)

        # shift-invariant per-class channel bias (keeps the task learnable
        # under the circular-shift nuisance below)
        chan_bias = rng.normal(0, 0.5, size=(c, 1, 1, self.channels)).astype(
            np.float32)

        labels = rng.integers(0, c, size=n)
        contrast = rng.uniform(0.6, 1.4, size=(n, 1, 1, 1)).astype(np.float32)
        x = templates[labels] * contrast
        # random circular shifts (nuisance)
        sh = rng.integers(-2, 3, size=(n, 2))
        for i in range(n):
            x[i] = np.roll(x[i], tuple(sh[i]), axis=(0, 1))
        x += chan_bias[labels]
        x += rng.normal(0, self.noise, x.shape).astype(np.float32)
        return x.astype(np.float32), labels.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SyntheticTextTask:
    num_classes: int
    vocab_size: int = 2000
    seq_len: int = 64
    n_keywords: int = 12     # class-indicative tokens per class
    keyword_rate: float = 0.12
    seed: int = 0

    def generate(self, n: int, seed: int | None = None):
        rng = np.random.default_rng(self.seed if seed is None else seed)
        v, c, s = self.vocab_size, self.num_classes, self.seq_len
        base = 1.0 / (np.arange(v) + 10.0)   # Zipfian background
        base /= base.sum()
        keywords = rng.choice(np.arange(16, v), size=(c, self.n_keywords),
                              replace=False if c * self.n_keywords <= v - 16 else True)
        labels = rng.integers(0, c, size=n)
        toks = rng.choice(v, size=(n, s), p=base)
        kw_mask = rng.random((n, s)) < self.keyword_rate
        kw_pick = keywords[labels][np.arange(n)[:, None],
                                   rng.integers(0, self.n_keywords, (n, s))]
        toks = np.where(kw_mask, kw_pick, toks)
        return toks.astype(np.int32), labels.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SyntheticTabularTask:
    """Gaussian class blobs under a shared random rotation: the light MLP
    workload of the TOY task."""
    num_classes: int
    dim: int = 16
    noise: float = 1.0
    seed: int = 0

    def generate(self, n: int, seed: int | None = None):
        rng = np.random.default_rng(self.seed if seed is None else seed)
        # class means fixed by a task-level rng so train/test share them
        mrng = np.random.default_rng(self.seed + 77)
        means = mrng.normal(0, 1, size=(self.num_classes, self.dim))
        means *= 2.0 / (np.linalg.norm(means, axis=1, keepdims=True) + 1e-9)
        rot, _ = np.linalg.qr(mrng.normal(0, 1, (self.dim, self.dim)))
        labels = rng.integers(0, self.num_classes, size=n)
        x = means[labels] + rng.normal(0, self.noise, (n, self.dim))
        return (x @ rot).astype(np.float32), labels.astype(np.int64)


def make_task_data(task: PaperTask, n_train: int, n_test: int, seed: int = 0):
    """Generate (train_x, train_y, test_x, test_y) for an image, tabular or
    text task."""
    if task.kind == "image":
        gen = SyntheticImageTask(task.num_classes, hw=task.image_hw, seed=seed)
    elif task.kind == "tabular":
        gen = SyntheticTabularTask(task.num_classes, dim=task.feat_dim,
                                   seed=seed)
    else:
        gen = SyntheticTextTask(task.num_classes, vocab_size=task.vocab_size,
                                seq_len=task.seq_len, seed=seed)
    xtr, ytr = gen.generate(n_train, seed=seed)
    xte, yte = gen.generate(n_test, seed=seed + 10_000)
    return xtr, ytr, xte, yte


def lm_token_batches(rng: np.random.Generator, batch: int, seq: int,
                     vocab: int) -> np.ndarray:
    """(batch, seq) int32 Markov-chain token stream for LM training: a
    shared bigram backbone with random jumps."""
    state = rng.integers(0, vocab, size=batch)
    stride = max(1, vocab // 17)
    out = np.empty((batch, seq), np.int32)
    for t in range(seq):
        jump = rng.random(batch) < 0.15
        nxt = np.where(jump, rng.integers(0, vocab, batch),
                       (state * 31 + 7) % max(1, vocab - stride)
                       + rng.integers(0, stride, batch))
        out[:, t] = nxt
        state = nxt
    return out
