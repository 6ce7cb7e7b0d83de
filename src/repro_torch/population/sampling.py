"""Hierarchical O(cohort) sampling over a sharded client population.

A copy of ``repro.population.sampling`` (numpy only): for any
``(shard_sizes, k, exclude)`` and generator state it draws the reference's
ids, consuming the generator identically.

The FL loop samples a K-client cohort uniformly WITHOUT replacement each
round.  The flat implementation (``rng.choice(n_clients, K, replace=False)``)
is O(population) per round — numpy builds a permutation-sized workspace —
and, worse, forces the caller to hold an O(population) id array for the
async loop's idle-set refills.  ``HierarchicalSampler`` does the same draw
in two stages over the population's contiguous shards:

  1. shard COUNTS from one multivariate-hypergeometric draw, sized by each
     shard's available-client count — the "size-weighted" stage that keeps
     the marginal exactly uniform-without-replacement over clients;
  2. within each selected shard, offsets uniformly without replacement.

Cost is O(n_shards + cohort) per draw, independent of the population size
(shards are population/shard_size, typically a few hundred at 1M clients);
in the cross-device regime (cohort ≪ population) a rejection fast path
collapses the two stages into one vectorized O(cohort) draw with no
shard-stage cost at all — same distribution, see ``sample``.

Degenerate equivalence (the regression suites pin this down): with
``n_shards == 1`` the two-stage draw collapses to the EXACT flat calls the
loop historically made — ``rng.choice(n, K, replace=False)`` for a fresh
cohort and ``rng.choice(n - |excluded|, K, replace=False)`` mapped through
the sorted idle ids for an async refill — consuming the generator
identically, so a seed reproduces the historical cohort sequence bit for
bit.

Exclusion (the async loop's in-flight clients) is handled by shrinking each
shard's available count and drawing POSITIONS among the survivors, then
shifting positions past the sorted excluded ids back to client ids — an
order-statistics map, O(|excluded| · cohort) with |excluded| ≤ cohort.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


def shift_positions(pos: np.ndarray, excluded_sorted: np.ndarray) -> np.ndarray:
    """Map positions among the non-excluded ids to the ids themselves.

    ``pos[i] = p`` means "the p-th smallest id not in ``excluded_sorted``";
    the return value is that id.  Equivalent to
    ``np.setdiff1d(np.arange(n), excluded_sorted)[pos]`` without ever
    building the O(n) survivor array.
    """
    out = np.asarray(pos, np.int64).copy()
    for v in excluded_sorted:            # ascending: each shift is final
        out[out >= v] += 1
    return out


class HierarchicalSampler:
    """Uniform-without-replacement cohort sampling in O(shards + cohort).

    ``shard_sizes[s]`` is the number of clients in shard ``s``; shards are
    contiguous id ranges (shard ``s`` owns ids
    ``[starts[s], starts[s] + shard_sizes[s])``).
    """

    def __init__(self, shard_sizes: Iterable[int]):
        self.shard_sizes = np.asarray(list(shard_sizes), np.int64)
        if len(self.shard_sizes) == 0 or (self.shard_sizes <= 0).any():
            raise ValueError(
                f"shard_sizes must be non-empty and positive, got "
                f"{self.shard_sizes!r}")
        self.starts = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(self.shard_sizes)])
        self.n_clients = int(self.starts[-1])
        self.n_shards = len(self.shard_sizes)

    def shard_of(self, cid: int) -> int:
        return int(np.searchsorted(self.starts, cid, side="right") - 1)

    def sample(self, rng: np.random.Generator, k: int,
               exclude: Optional[Iterable[int]] = None) -> np.ndarray:
        """Draw ``k`` distinct client ids uniformly at random, never one in
        ``exclude``.  One shard degenerates to the flat historical calls
        (see the module docstring); more shards do the two-stage draw."""
        exc = (np.unique(np.fromiter(exclude, np.int64))
               if exclude else np.empty(0, np.int64))
        avail_total = self.n_clients - len(exc)
        if k > avail_total:
            raise ValueError(f"cannot sample {k} clients from "
                             f"{avail_total} available")
        if self.n_shards == 1:
            if len(exc) == 0:
                return rng.choice(self.n_clients, size=k, replace=False)
            pos = rng.choice(avail_total, size=k, replace=False)
            return shift_positions(pos, exc)

        # Cross-device regime fast path (cohort + excluded ≪ population):
        # the size-weighted shard stage composed with uniform within-shard
        # offsets IS the uniform k-subset of [0, n) — so draw global ids
        # directly by vectorized rejection: sample every position iid
        # uniform, then redraw excluded hits and later-index duplicates
        # until none remain.  Each position only ever redraws against the
        # exclusion set and earlier positions' final values — sequential
        # sampling without replacement, exactly uniform over survivors —
        # and with (k + |exc|) at most n/64 a draw resolves in O(1)
        # expected rounds.  This skips the O(n_shards) hypergeometric
        # stage entirely; the two-stage draw below remains for dense
        # cohorts where collisions would thrash.
        if (k + len(exc)) * 64 <= self.n_clients:
            out = rng.integers(0, self.n_clients, size=k)
            while True:
                _, first = np.unique(out, return_index=True)
                bad = np.ones(k, bool)
                bad[first] = False
                if len(exc):
                    bad |= np.isin(out, exc)
                if not bad.any():
                    return out
                out[bad] = rng.integers(0, self.n_clients,
                                        size=int(bad.sum()))

        # per-shard available counts (excluded ids bucketed by shard)
        avail = self.shard_sizes.copy()
        exc_shards = np.empty(0, np.int64)
        if len(exc):
            shard_of_exc = np.searchsorted(self.starts, exc,
                                           side="right") - 1
            np.subtract.at(avail, shard_of_exc, 1)
            exc_shards = np.unique(shard_of_exc)
        counts = rng.multivariate_hypergeometric(avail, k)
        sel = np.nonzero(counts)[0]
        with_exc = np.isin(sel, exc_shards)
        out = []
        clean = sel[~with_exc]
        if len(clean):
            # Shards untouched by exclusion (at a K=64 cohort over hundreds
            # of shards: nearly all of them) draw their offsets in ONE
            # vectorized pass: sample every offset iid uniform, then redraw
            # later-index intra-shard duplicates until none remain.  Each
            # position only ever redraws against earlier positions' final
            # values, so the result is exactly sequential sampling without
            # replacement — uniform over distinct offset sets — while a
            # typical draw resolves in zero redraw rounds (collision odds
            # ~ cohort / shard_size per pair).  This replaces a Python loop
            # of per-shard ``rng.choice`` calls whose dispatch overhead
            # dominated the whole draw (~10x the hypergeometric stage).
            sizes_rep = np.repeat(avail[clean], counts[clean])
            shard_rep = np.repeat(clean, counts[clean])
            offs = rng.integers(0, sizes_rep)
            key_base = int(self.shard_sizes.max()) + 1
            while True:
                _, first = np.unique(shard_rep * key_base + offs,
                                     return_index=True)
                if len(first) == len(offs):
                    break
                dup = np.ones(len(offs), bool)
                dup[first] = False
                offs[dup] = rng.integers(0, sizes_rep[dup])
            out.append(self.starts[shard_rep] + offs)
        for s in sel[with_exc]:
            c = int(counts[s])
            lo, size = int(self.starts[s]), int(avail[s])
            pos = rng.choice(size, size=c, replace=False)
            exc_here = exc[(exc >= lo)
                           & (exc < lo + int(self.shard_sizes[s]))] - lo
            out.append(lo + shift_positions(pos, exc_here))
        return np.concatenate(out) if out else np.empty(0, np.int64)
