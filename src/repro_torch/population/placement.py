"""Multi-host placement for the population tier.

The port of ``repro.population.placement``.  With ``HostPlacement(host_id,
n_hosts)`` attached to a ``Population``, every host runs the same sampler
draws (the numpy generators stay in lockstep: ``fl_loop._multihost_round``)
but materializes only the slice of the cohort it owns.  Ownership is by
shard:

    host(cid) = shard_of(cid) % n_hosts

so a host's warm LRU holds only clients of its own shards and is capped at
``warm_cap // n_hosts``.  After its slice trains, a host publishes its
uploads through a filesystem allgather (write to a temporary file,
``os.replace``, then poll: a visible file is always complete) and every
host runs the same server update on the full upload list in cohort order,
so the global state never diverges between hosts.

A payload is one ``.npz`` per (tag, host): the arrays of the object plus
its spec (``checkpoint.recovery``'s encoding: dict / list / tuple /
tensors / numpy arrays / scalars) as JSON bytes under ``__spec__``.  The
reference embeds a msgpack spec; the card's host has no msgpack, so the two
packages' exchange files do not mix, as their checkpoints do not.  Tensors
go to the host on ``publish`` and come back on the ``device`` the gather
names; each host reads its own payload from its file too, so every host
consumes byte-identical inputs.  A payload is O(cohort slice), never
O(population).

This module is transport only: it runs no model and touches no card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.recovery import _decode, _encode

_SPEC_KEY = "__spec__"


@dataclasses.dataclass(frozen=True)
class HostPlacement:
    """Which slice of the population this process owns.

    Args:
      host_id: this process's rank in ``[0, n_hosts)``.
      n_hosts: participating processes.  ``n_hosts == 1`` is inert: every
        path reduces to the single-host one, bit for bit.
      exchange_dir: the shared directory of the cross-host exchange
        (required when ``n_hosts > 1``; NFS, or for processes of one
        machine a directory they all see).
      timeout_s: how long to wait for a peer's payload before declaring
        the topology dead.
      poll_s: the pause between two polls of the exchange directory.

    ``stats`` accumulates the exchange's telemetry over the run
    (exchanges, polled waits, seconds spent waiting, deadline misses and
    the last missing host set, and the milliseconds this host spent
    publishing and gathering); it is left out of equality and repr, so
    placements compare by topology, and it lands in
    ``History.telemetry["population"]["hosts"]``.
    """

    host_id: int
    n_hosts: int
    exchange_dir: Optional[str] = None
    timeout_s: float = 300.0
    poll_s: float = 0.02
    stats: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def __post_init__(self):
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if not (0 <= self.host_id < self.n_hosts):
            raise ValueError(f"host_id {self.host_id} out of range "
                             f"[0, {self.n_hosts})")
        if self.n_hosts > 1 and not self.exchange_dir:
            raise ValueError("n_hosts > 1 needs exchange_dir= (a directory "
                             "every host can read and write)")

    def owns_shard(self, shard: int) -> bool:
        return shard % self.n_hosts == self.host_id

    def split_cap(self, cap: Optional[int]) -> Optional[int]:
        """A global warm cap divided into this host's share (at least 1)."""
        if cap is None:
            return None
        return max(1, cap // self.n_hosts)


# ---------------------------------------------------------------------------
# the filesystem allgather
# ---------------------------------------------------------------------------

def _payload_path(exchange_dir: str, tag: str, host: int) -> str:
    return os.path.join(exchange_dir, f"{tag}_host{host:03d}.npz")


def _bump(placement: HostPlacement, key: str, by: float = 1) -> None:
    placement.stats[key] = placement.stats.get(key, 0) + by


def publish(placement: HostPlacement, tag: str, obj: Any) -> str:
    """Write this host's payload for ``tag``: one file, atomically."""
    t0 = time.perf_counter()
    arrays: dict = {}
    spec = _encode(obj, arrays)
    flat = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in arrays.items()}
    flat[_SPEC_KEY] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
    path = _payload_path(placement.exchange_dir, tag, placement.host_id)
    os.makedirs(placement.exchange_dir, exist_ok=True)
    tmp = f"{path}.tmp{placement.host_id}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)           # readers never see a partial file
    _bump(placement, "publish_ms", (time.perf_counter() - t0) * 1e3)
    return path


def _read_payload(path: str, device) -> Any:
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    spec = json.loads(arrays.pop(_SPEC_KEY).tobytes())
    return _decode(spec, {k: torch.from_numpy(v) for k, v in arrays.items()},
                   device)


def _gather(placement: HostPlacement, tag: str, obj: Any, strict: bool,
            skip_wait=(), device="cpu") -> tuple[list, tuple[int, ...]]:
    """Publish ``obj``, then poll every host's ``tag`` payload until all
    have landed or the deadline passes.  Returns ``(payloads, missing)``,
    ``payloads[h]`` None for each host in ``missing``.  A host in
    ``skip_wait`` (already declared crashed: crash-stop) gets one existence
    check and no polling, so a dead peer does not cost a full time-out on
    every later exchange."""
    publish(placement, tag, obj)
    _bump(placement, "exchanges")
    pending = set(range(placement.n_hosts))
    got: set = set()
    out: list = [None] * placement.n_hosts
    start = time.monotonic()
    deadline = start + placement.timeout_s
    polled = False
    while pending:
        for h in sorted(pending):
            path = _payload_path(placement.exchange_dir, tag, h)
            if os.path.exists(path):
                out[h] = _read_payload(path, device)
                got.add(h)
                pending.discard(h)
        pending.difference_update(skip_wait)
        if not pending or time.monotonic() > deadline:
            break
        polled = True
        time.sleep(placement.poll_s)
    if polled:
        _bump(placement, "waits")
        _bump(placement, "wait_s", round(time.monotonic() - start, 6))
    _bump(placement, "gather_ms", (time.monotonic() - start) * 1e3)
    missing = tuple(h for h in range(placement.n_hosts) if h not in got)
    if missing:
        _bump(placement, "timeouts")
        placement.stats["last_missing"] = list(missing)
        placement.stats["last_missing_tag"] = tag
        if strict:
            raise RuntimeError(
                f"multi-host exchange {tag!r} timed out after "
                f"{placement.timeout_s:.0f}s: missing host(s) "
                f"{list(missing)} of {placement.n_hosts} "
                f"(exchange_dir={placement.exchange_dir}): are the "
                f"workers alive?")
    return out, missing


def allgather(placement: HostPlacement, tag: str, obj: Any,
              device="cpu") -> list:
    """Publish ``obj`` and block until every host's ``tag`` payload has
    landed; the payloads indexed by host id, tensors on ``device`` (this
    host's own is read back from its file too).  On time-out it raises,
    naming every missing host and the tag."""
    out, _ = _gather(placement, tag, obj, strict=True, device=device)
    return out


def allgather_partial(placement: HostPlacement, tag: str, obj: Any,
                      skip_wait=(), device="cpu"
                      ) -> tuple[list, tuple[int, ...]]:
    """``allgather`` that degrades instead of raising: a host that misses
    the deadline is in ``missing`` (its payload ``None``), so the
    fault-tolerant round can treat it as crashed.  Under crash-stop every
    survivor resolves the same missing set (given a time-out well above
    the live hosts' skew).  Hosts in ``skip_wait`` are checked once and
    never polled for."""
    return _gather(placement, tag, obj, strict=False, skip_wait=skip_wait,
                   device=device)


# ---------------------------------------------------------------------------
# the coordinated resume
# ---------------------------------------------------------------------------

_AVAIL_TAG = "resume-avail"


def resume_barrier(placement: HostPlacement,
                   avail: Optional[int]) -> Optional[int]:
    """Phase 1 of the coordinated resume: exchange each host's newest
    loadable checkpoint round and agree on the common restore point.

    Returns the minimum over the hosts (the latest round every host can
    load: a host that checkpointed further still has the earlier file), or
    ``None`` when every host starts fresh.  A mix of fresh and resumable
    hosts raises: they could never reconverge."""
    got = allgather(placement, _AVAIL_TAG, {"avail": avail})
    vals = [g["avail"] for g in got]
    if all(v is None for v in vals):
        return None
    if any(v is None for v in vals):
        fresh = [h for h, v in enumerate(vals) if v is None]
        raise RuntimeError(
            f"coordinated resume: host(s) {fresh} have no loadable "
            f"checkpoint but peers report rounds "
            f"{[v for v in vals if v is not None]}: mixed fresh/resume "
            f"states cannot reconverge; clear or repair the checkpoint "
            f"dirs")
    return min(int(v) for v in vals)


def confirm_resume(placement: HostPlacement, common: Optional[int],
                   meta: dict) -> None:
    """Phase 2: every host publishes what it restored (round, version,
    algorithm, ...) under a tag that names the common round, and checks
    that its peers restored the same before the first round runs.  A host
    that computed another restore point waits on a tag nobody publishes
    and fails at the time-out instead of diverging.  Completing the
    barrier proves every peer read this host's phase-1 payload, so that
    file is retired here."""
    tag = ("resume-ok-fresh" if common is None
           else f"resume-ok-r{common:06d}")
    got = allgather(placement, tag, dict(meta))
    mine = got[placement.host_id]
    for h, g in enumerate(got):
        if g != mine:
            raise RuntimeError(
                f"coordinated resume diverged: host {placement.host_id} "
                f"restored {mine} but host {h} restored {g}: refusing to "
                f"run the first round from inconsistent state")
    try:
        os.remove(_payload_path(placement.exchange_dir, _AVAIL_TAG,
                                placement.host_id))
    except OSError:
        pass


def clear_host_payloads(placement: HostPlacement,
                        keep_prefixes: tuple = ("resume-",)) -> int:
    """Delete every exchange payload this host has published (round and
    wave files; the resume barrier's are kept).  Run on resume before the
    confirm barrier: a surviving host may have published past the restore
    point on the assumption that a dead peer stayed dead, and such a file
    must not satisfy a peer's poll once the replay takes another course.
    Own files only; the confirm barrier orders every deletion before any
    read after the resume.  Returns the number removed."""
    d = placement.exchange_dir
    if not d or not os.path.isdir(d):
        return 0
    suffix = f"_host{placement.host_id:03d}.npz"
    removed = 0
    for name in sorted(os.listdir(d)):
        if not name.endswith(suffix) or any(name.startswith(p)
                                            for p in keep_prefixes):
            continue
        try:
            os.remove(os.path.join(d, name))
            removed += 1
        except OSError:
            pass
    return removed


def peak_rss_mb() -> float:
    """This process's peak resident set (VmHWM), in MB; NaN where
    ``/proc/self/status`` cannot be read."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return float("nan")
