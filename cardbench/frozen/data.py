"""The cells' data, made from the seed, and the draws the port makes from
its own seed, copied so that the reference can make them again.

* ``federated_images``: a CIFAR-sized image set on the card (the port's
  synthetic recipe: per-class low-frequency templates times a random
  contrast, a per-class channel bias, Gaussian noise, a random circular
  shift), split over clients by ``dirichlet_partition``: the source's
  unequal non-IID shards, drawn once from the configuration's partition
  seed, so that every run holds the same shards and the seed moves only
  the images, the cohorts and the batches.
* ``dirichlet_partition``: the paper's partition (Hsu et al. 2019; the
  port's ``data.dirichlet``), a Dir(α) draw over the clients per class.
* ``cohort`` and ``client_picks``: ``FederatedData.sample_cohort`` and
  ``executor.materialize_picks`` of the port, numpy in the same order.
* ``lm_token_batches``, ``client_token_batches``, ``eval_tokens``: the
  LM trainer's Markov token streams (``data.synthetic.lm_token_batches``,
  ``launch.train.client_batches`` and its evaluation batch).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

LM_EVAL_SEED, LM_EVAL_BATCH = 9999, 8


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def image_classes(gen: torch.Generator, classes: int, hw: int,
                  channels: int, device):
    """(templates (C, hw, hw, ch) at unit RMS, channel bias (C, 1, 1, ch))."""
    lin = torch.linspace(0.0, 1.0, hw, device=device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    f = _uniform(gen, (classes, channels, 3, 2), 0.5, 3.0, device)
    ph = _uniform(gen, (classes, channels, 3), 0.0, 2 * math.pi, device)
    waves = torch.sin(2 * math.pi * (f[..., 0, None, None] * xx
                                     + f[..., 1, None, None] * yy)
                      + ph[..., None, None])          # (C, ch, 3, hw, hw)
    t = waves.sum(2).permute(0, 2, 3, 1).contiguous()  # (C, hw, hw, ch)
    t = t / torch.sqrt((t ** 2).mean((1, 2, 3), keepdim=True) + 1e-8)
    bias = 0.5 * torch.randn((classes, 1, 1, channels), generator=gen,
                             device=device)
    return t, bias


def images(gen: torch.Generator, labels: torch.Tensor, templates, bias,
           noise: float = 0.8, max_shift: int = 2) -> torch.Tensor:
    """(N, hw, hw, ch) fp32 images of ``labels`` (N,) on the card."""
    n, hw = labels.shape[0], templates.shape[1]
    dev = labels.device
    contrast = _uniform(gen, (n, 1, 1, 1), 0.6, 1.4, dev)
    shift = torch.randint(-max_shift, max_shift + 1, (n, 2), generator=gen,
                          device=dev)
    ar = torch.arange(hw, device=dev)
    iy = (ar[None, :] - shift[:, :1]) % hw               # (N, hw)
    ix = (ar[None, :] - shift[:, 1:]) % hw
    x = templates[labels[:, None, None], iy[:, :, None], ix[:, None, :]]
    x = x * contrast + bias[labels]
    return x + noise * torch.randn(x.shape, generator=gen, device=dev)


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int, min_per_client: int = 2) -> list:
    """Client index arrays, a disjoint cover of ``labels``: for each class
    a Dir(α) draw over the clients decides the share of that class each
    client receives; a client under ``min_per_client`` takes examples from
    the largest."""
    rng = np.random.default_rng(seed)
    client_idx: list = [[] for _ in range(n_clients)]
    for c in range(int(labels.max()) + 1):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    for k in np.argsort([len(ci) for ci in client_idx]):
        while len(client_idx[k]) < min_per_client:
            donor = int(np.argmax([len(ci) for ci in client_idx]))
            client_idx[k].append(client_idx[donor].pop())
    return [np.array(sorted(ci), dtype=np.int64) for ci in client_idx]


def federated_images(seed: int, *, n_clients: int, train_size: int,
                     partition_seed: int, n_test: int, classes: int,
                     hw: int, channels: int, alpha: float, device) -> dict:
    """The clients' shards and the test set as host numpy arrays (the
    port's ``FederatedData`` holds numpy): ``clients`` [(x, y)], ``test_x``,
    ``test_y``, ``label_matrix`` (K, C).  The training labels and their
    partition come from ``partition_seed``; the images and the test labels
    from ``seed``."""
    prng = np.random.default_rng(partition_seed)
    train_y = prng.integers(0, classes, size=train_size).astype(np.int64)
    parts = dirichlet_partition(train_y, n_clients, alpha, partition_seed)
    rng = np.random.default_rng(seed)
    test_y = rng.integers(0, classes, size=n_test).astype(np.int64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    templates, bias = image_classes(gen, classes, hw, channels, device)
    ys = torch.from_numpy(np.concatenate([train_y, test_y]))
    x = images(gen, ys.to(device), templates, bias).cpu().numpy()
    clients = [(x[idx], train_y[idx]) for idx in parts]
    counts = np.stack([np.bincount(train_y[idx], minlength=classes)
                       for idx in parts])
    return {"clients": clients, "test_x": x[train_size:], "test_y": test_y,
            "label_matrix": counts}


# ---------------------------------------------------------------------------
# the port's own draws from its seed, in its order

def cohort(rng: np.random.Generator, n_clients: int, k: int) -> np.ndarray:
    """``FederatedData.sample_cohort`` without exclusions."""
    return rng.choice(n_clients, size=k, replace=False)


def client_picks(rng: np.random.Generator, n: int, batch_size: int,
                 epochs: int, max_batches: Optional[int] = None) -> np.ndarray:
    """``executor.materialize_picks``: (S, bs) row indices, one permutation
    per started epoch, a final partial batch wrap-padded."""
    bs = min(batch_size, n)
    picks = []
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, bs):
            idx = order[i:i + bs]
            if len(idx) < bs:
                idx = np.concatenate([idx, order[: bs - len(idx)]])
            picks.append(idx)
            if max_batches is not None and len(picks) >= max_batches:
                break
        if max_batches is not None and len(picks) >= max_batches:
            break
    return np.stack(picks).astype(np.int64)


def client_steps(n: int, batch_size: int, epochs: int,
                 max_batches: Optional[int] = None) -> int:
    """The number of rows of ``client_picks``: its local steps."""
    steps = epochs * math.ceil(n / min(batch_size, n))
    return steps if max_batches is None else min(steps, max_batches)


def lm_token_batches(rng: np.random.Generator, batch: int, seq: int,
                     vocab: int) -> np.ndarray:
    """(batch, seq) int32 Markov-chain tokens: a shared bigram backbone
    with random jumps."""
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


def client_token_batches(vocab: int, n_clients: int, batches: int,
                         batch: int, seq: int, seed: int) -> np.ndarray:
    """(K, batches, batch, seq) int32: client k from its own source,
    ``default_rng(seed * 1000 + k)``."""
    out = np.empty((n_clients, batches, batch, seq), np.int32)
    for k in range(n_clients):
        rng = np.random.default_rng(seed * 1000 + k)
        for b in range(batches):
            out[k, b] = lm_token_batches(rng, batch, seq, vocab)
    return out


def eval_tokens(vocab: int, seq: int) -> np.ndarray:
    """The LM trainer's evaluation batch: (8, seq) from a fixed seed."""
    return lm_token_batches(np.random.default_rng(LM_EVAL_SEED),
                            LM_EVAL_BATCH, seq, vocab)
