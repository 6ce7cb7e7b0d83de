"""Simulated system heterogeneity: the virtual clock behind async rounds.

The port of ``repro.core.systemsim``; everything but ``corrupt_params`` and
``measure_step_time`` is numpy, and draws the reference's numbers from the
same seed.  A ``SystemSim`` owns per-client compute speeds drawn once from
a ``SpeedProfile``, optional ``Availability`` windows, and a virtual clock
with an event heap of in-flight completions: ``dispatch(client, work,
tag)`` schedules a completion at ``start + work/speed`` and ``pop()``
consumes the earliest, advancing the clock.  The clock never goes
backwards, and equal completions leave in dispatch order (a monotone
sequence number breaks ties).

``FaultProfile`` and ``FaultInjector`` add client failures per dispatch:
a crash (the update never arrives), a timeout (it arrives after
``timeout_factor`` times the honest duration, and counts as dead) or a
corrupt upload (NaN, Inf or exploded-norm parameters).  Speeds and
availability draw from ``derive_rng(seed)``, faults from
``derive_fault_rng(seed)``: two child streams of the training seed, so
neither perturbs the other or the sampling stream, and a zero-probability
profile replays the fault-free run bit for bit.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map

# child-stream key for derive_rng: the sim draws from a stream SPAWNED off
# the training seed so async and sync runs consume the main rng identically
_SIM_STREAM_KEY = 0x5E1F
# a separate child stream for fault draws: faults must not perturb the
# speed/availability stream (or the main rng) so a zero-probability
# profile is bit-identical to no profile at all
_FAULT_STREAM_KEY = 0xFA17

_PROFILE_KINDS = ("homogeneous", "straggler", "lognormal", "uniform")

CORRUPT_MODES = ("nan", "inf", "huge")


def derive_rng(seed: int) -> np.random.Generator:
    """The canonical simulation generator for a training seed."""
    return np.random.default_rng(np.random.SeedSequence(
        entropy=seed, spawn_key=(_SIM_STREAM_KEY,)))


def derive_fault_rng(seed: int) -> np.random.Generator:
    """The canonical FAULT generator for a training seed (its own child
    stream: fault draws never consume the sim or sampling streams)."""
    return np.random.default_rng(np.random.SeedSequence(
        entropy=seed, spawn_key=(_FAULT_STREAM_KEY,)))


@dataclasses.dataclass(frozen=True)
class SpeedProfile:
    """How per-client compute speeds are drawn (speed 1.0 == baseline;
    duration of ``work`` units is ``work / speed``).

        homogeneous   every client at speed 1.0 (the equivalence regime)
        straggler     a ``straggler_frac`` tail runs ``straggler_slowdown``×
                      slower (the paper-style systems-heterogeneity case)
        lognormal     speed ~ LogNormal(0, sigma) — smooth heavy tail
        uniform       speed ~ U[lo, hi]
    """
    kind: str = "homogeneous"
    straggler_frac: float = 0.2
    straggler_slowdown: float = 4.0
    sigma: float = 0.5
    lo: float = 0.5
    hi: float = 2.0

    def __post_init__(self):
        if self.kind not in _PROFILE_KINDS:
            raise ValueError(f"unknown speed profile {self.kind!r}; "
                             f"available: {_PROFILE_KINDS}")


@dataclasses.dataclass(frozen=True)
class Availability:
    """Periodic duty-cycle availability: client ``k`` is reachable during
    ``[n*period + phase_k, n*period + phase_k + duty*period)`` for every
    integer ``n``.  Phases are drawn per client from the sim generator so
    windows are staggered; ``duty=1`` disables the model."""
    period: float = 64.0
    duty: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.duty <= 1.0):
            raise ValueError(f"duty must be in (0, 1], got {self.duty}")
        if self.period <= 0.0:
            raise ValueError(f"period must be positive, got {self.period}")


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Per-dispatch failure model (all probabilities independent draws).

        crash_prob      client dies mid-round: the update never arrives
        timeout_prob    client straggles into the timeout tail: its
                        completion lands at ``timeout_factor`` × the
                        honest duration, past any deadline — the server
                        treats it exactly like a crash, but it is counted
                        separately (and occupies the async event heap for
                        the inflated duration)
        corrupt_prob    the update arrives but is garbage; the corruption
                        MODE is drawn uniformly from ``corrupt_modes``:
                        "nan" / "inf" poison one parameter element,
                        "huge" scales every parameter by ``huge_scale``
                        (finite, but a norm outlier)
        host_crash_prob  a correlated fault of a whole host under multi-host
                        placement; validated here, but multi-host is not
                        ported (ROADMAP A13) and ``run_federated`` refuses
                        a profile that sets it

    A profile with all probabilities zero is exactly equivalent to no
    profile: the fault stream is still drawn from, but from its OWN child
    stream (``derive_fault_rng``), so nothing else shifts.
    """
    crash_prob: float = 0.0
    timeout_prob: float = 0.0
    corrupt_prob: float = 0.0
    corrupt_modes: tuple = CORRUPT_MODES
    timeout_factor: float = 16.0
    huge_scale: float = 1e6
    host_crash_prob: float = 0.0

    def __post_init__(self):
        total = self.crash_prob + self.timeout_prob + self.corrupt_prob
        if not (0.0 <= total <= 1.0):
            raise ValueError(
                f"fault probabilities must sum into [0, 1], got {total}")
        if not (0.0 <= self.host_crash_prob <= 1.0):
            raise ValueError(f"host_crash_prob must be in [0, 1], got "
                             f"{self.host_crash_prob}")
        for m in self.corrupt_modes:
            if m not in CORRUPT_MODES:
                raise ValueError(f"unknown corrupt mode {m!r}; "
                                 f"available: {CORRUPT_MODES}")

    @property
    def any(self) -> bool:
        return (self.crash_prob + self.timeout_prob
                + self.corrupt_prob + self.host_crash_prob) > 0.0


class FaultInjector:
    """Seeded per-dispatch fault draws + injection counters.

    ``draw()`` consumes ONE uniform per dispatch (plus one more only when
    a corruption fires, to pick the mode), so the fault sequence is a pure
    function of the seed and the dispatch order — the three synchronous
    executors share a dispatch order (the sampled cohort) and therefore
    fire identical faults.
    """

    def __init__(self, profile: FaultProfile,
                 rng: Optional[np.random.Generator] = None):
        self.profile = profile
        self.rng = rng if rng is not None else derive_fault_rng(0)
        self.counters = {"crashes": 0, "timeouts": 0, "corrupt_injected": 0,
                         "host_crashes": 0}

    def draw(self) -> "tuple[str, str] | None":
        """``None`` (healthy) or ``(kind, mode)`` with kind in
        crash/timeout/corrupt and mode one of ``CORRUPT_MODES`` (empty
        string for non-corrupt kinds)."""
        p = self.profile
        u = self.rng.random()
        if u < p.crash_prob:
            self.counters["crashes"] += 1
            return ("crash", "")
        if u < p.crash_prob + p.timeout_prob:
            self.counters["timeouts"] += 1
            return ("timeout", "")
        if u < p.crash_prob + p.timeout_prob + p.corrupt_prob:
            mode = p.corrupt_modes[
                int(self.rng.integers(len(p.corrupt_modes)))]
            self.counters["corrupt_injected"] += 1
            return ("corrupt", mode)
        return None


def corrupt_params(params: Any, mode: str, huge_scale: float = 1e6) -> Any:
    """Apply one corruption mode to a parameter tree (pure).

    "nan" / "inf" poison element ``[0, ..., 0]`` of the first leaf in
    flatten order (the validator must scan the whole tree to find it);
    "huge" multiplies every leaf by ``huge_scale``: all finite, caught only
    by the norm gate.
    """
    if mode == "huge":
        return tree_map(lambda l: l * huge_scale, params)
    if mode not in ("nan", "inf"):
        raise ValueError(f"unknown corrupt mode {mode!r}")
    leaves, rebuild = tree_flatten(params)
    first = leaves[0].clone()
    first[(0,) * first.ndim] = float("nan") if mode == "nan" else float("inf")
    return rebuild([first] + leaves[1:])


def draw_speeds(profile: SpeedProfile, n_clients: int,
                rng: np.random.Generator) -> np.ndarray:
    """(K,) float64 per-client speeds, strictly positive."""
    if profile.kind == "homogeneous":
        return np.ones(n_clients)
    if profile.kind == "straggler":
        speeds = np.ones(n_clients)
        slow = rng.random(n_clients) < profile.straggler_frac
        speeds[slow] = 1.0 / profile.straggler_slowdown
        return speeds
    if profile.kind == "lognormal":
        return np.exp(rng.normal(0.0, profile.sigma, n_clients))
    # uniform
    return rng.uniform(profile.lo, profile.hi, n_clients)


class Completion(NamedTuple):
    """One client finishing its local work (popped from the event heap)."""
    time: float     # virtual completion time
    seq: int        # monotone dispatch sequence number (the tie-break)
    client: int
    tag: Any        # caller payload (the async loop stores the update here)


class SystemSim:
    """Virtual clock + in-flight completion heap over K simulated clients.

    ``now`` only moves forward (``pop`` advances it to the completion's
    time); dispatches happen AT ``now`` and complete strictly later.  All
    counters (dispatches, availability delays, total waiting) are plain
    ints/floats derived from seeded draws — two sims built from the same
    generator state replay bit-identically.
    """

    def __init__(self, n_clients: int, profile: Optional[SpeedProfile] = None,
                 availability: Optional[Availability] = None,
                 rng: Optional[np.random.Generator] = None,
                 base_step_time: float = 1.0):
        if base_step_time <= 0.0:
            raise ValueError(f"base_step_time must be positive, got "
                             f"{base_step_time}")
        rng = rng if rng is not None else np.random.default_rng(0)
        self.profile = profile if profile is not None else SpeedProfile()
        self.speeds = draw_speeds(self.profile, n_clients, rng)
        self.availability = availability
        self.phases = (rng.random(n_clients) * availability.period
                       if availability is not None else None)
        self.base_step_time = float(base_step_time)
        self.now = 0.0
        self._heap: list[tuple[float, int, int, Any]] = []
        self._seq = 0
        self.dispatches = 0
        self.availability_delays = 0
        self.total_wait = 0.0

    # -- geometry ---------------------------------------------------------
    def duration(self, client: int, work: float) -> float:
        """Virtual seconds for ``work`` units on ``client``."""
        return self.base_step_time * float(work) / float(self.speeds[client])

    def next_available(self, client: int, t: float) -> float:
        """Earliest time >= t the client's availability window is open."""
        av = self.availability
        if av is None or av.duty >= 1.0:
            return t
        local = (t - self.phases[client]) % av.period
        if local < av.duty * av.period:
            return t
        return t + (av.period - local)

    # -- event machinery --------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._heap)

    def dispatch(self, client: int, work: float, tag: Any = None, *,
                 delay: float = 0.0, slowdown: float = 1.0) -> float:
        """Start ``work`` units on ``client`` at the current clock (or its
        next availability window); returns the scheduled completion time.

        ``delay`` pushes the earliest start past ``now`` (the retry
        path's exponential backoff on the simulated clock); ``slowdown``
        inflates the duration (the fault model's timeout tail).
        """
        earliest = self.now + delay
        start = self.next_available(client, earliest)
        if start > earliest:
            # only the availability wait counts here; the caller tracks
            # its own backoff delay in the fault telemetry
            self.availability_delays += 1
            self.total_wait += start - earliest
        completion = start + self.duration(client, work) * slowdown
        heapq.heappush(self._heap, (completion, self._seq, client, tag))
        self._seq += 1
        self.dispatches += 1
        return completion

    def pop(self) -> Completion:
        """Consume the earliest completion, advancing the clock (monotone:
        remaining heap entries are all >= the popped time)."""
        if not self._heap:
            raise RuntimeError("SystemSim.pop: no in-flight clients")
        t, seq, client, tag = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return Completion(t, seq, client, tag)

    def pop_batch(self, b: int) -> list[Completion]:
        """The next ``b`` completions in time order (the aggregation
        buffer fill of the async server)."""
        if b > len(self._heap):
            raise RuntimeError(
                f"SystemSim.pop_batch({b}): only {len(self._heap)} in flight")
        return [self.pop() for _ in range(b)]

    def stats(self) -> dict:
        return {"sim_time": self.now, "dispatches": self.dispatches,
                "in_flight": self.in_flight,
                "availability_delays": self.availability_delays,
                "total_wait": self.total_wait,
                "speed_min": float(self.speeds.min()),
                "speed_max": float(self.speeds.max()),
                "speed_mean": float(self.speeds.mean())}

    # -- checkpointing ----------------------------------------------------
    def state(self) -> dict:
        """A snapshot of all mutable sim state: the clock, the in-flight
        heap and the counters, with the speeds and phases so the snapshot
        does not depend on construction order.  The async loop's tags hold
        upload tensors, maybe on the card: they are copied to host numpy
        here (``restore`` brings them back to a device), so the snapshot
        shares no memory with the live heap."""
        return {"now": float(self.now),
                "heap": [(t, seq, client, _to_host(tag))
                         for t, seq, client, tag in self._heap],
                "seq": self._seq,
                "dispatches": self.dispatches,
                "availability_delays": self.availability_delays,
                "total_wait": float(self.total_wait),
                "speeds": [float(s) for s in self.speeds],
                "phases": ([float(p) for p in self.phases]
                           if self.phases is not None else None)}

    def restore(self, state: dict, device="cpu") -> None:
        """Rehydrate from ``state()``, the tags' arrays as tensors on
        ``device``; the heap is re-heapified, so a hand-edited snapshot
        cannot corrupt the pop order."""
        self.now = float(state["now"])
        heap = [(float(t), int(seq), int(client), _to_device(tag, device))
                for t, seq, client, tag in state["heap"]]
        heapq.heapify(heap)
        self._heap = heap
        self._seq = int(state["seq"])
        self.dispatches = int(state["dispatches"])
        self.availability_delays = int(state["availability_delays"])
        self.total_wait = float(state["total_wait"])
        self.speeds = np.asarray(state["speeds"], np.float64)
        phases = state.get("phases")
        self.phases = (np.asarray(phases, np.float64)
                       if phases is not None else None)


def _to_host(tag: Any) -> Any:
    """Every tensor of a tag (nested dicts, tuples, lists) as host numpy."""
    if isinstance(tag, torch.Tensor):
        return tag.detach().cpu().numpy().copy()
    if isinstance(tag, dict):
        return {k: _to_host(v) for k, v in tag.items()}
    if isinstance(tag, (tuple, list)):
        return type(tag)(_to_host(v) for v in tag)
    return tag


def _to_device(tag: Any, device) -> Any:
    """``_to_host``'s inverse: every numpy array as a tensor on ``device``."""
    if isinstance(tag, np.ndarray):
        return torch.tensor(tag, device=device)
    if isinstance(tag, dict):
        return {k: _to_device(v, device) for k, v in tag.items()}
    if isinstance(tag, (tuple, list)):
        return type(tag)(_to_device(v, device) for v in tag)
    return tag


def measure_step_time(step_fn, *args, warmup: int = 1,
                      repeats: int = 3) -> float:
    """Median wall-clock seconds of one ``step_fn(*args)`` call, the card
    synchronised after each: the calibration input for
    ``SystemSim(base_step_time=...)``, which turns ``sim_time`` (in units
    of local work) into a prediction of real seconds."""
    def call():
        out = step_fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out

    for _ in range(max(0, warmup)):
        call()
    samples = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        call()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]
