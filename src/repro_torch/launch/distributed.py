"""Multi-process topologies for the multi-host federated loop, on
``torch.distributed``.

The port of ``repro.launch.distributed``.  The placement layer
(``repro_torch.population.placement``) needs no runtime: two plain
processes over a shared exchange directory already train in lockstep.  This
module brings the same processes up as one ``torch.distributed`` process
group, so a launcher takes each host's identity from the group
(``placement_from_runtime``) instead of threading it through argv, and the
group's collectives run for real.  The backend is gloo: it runs on the CPU,
and it runs two ranks on one GPU, which NCCL refuses.

A two-process launch on one machine:

    python -m repro_torch.launch.distributed \\
        --coordinator 127.0.0.1:<port> --num-processes 2 --process-id 0 &
    python -m repro_torch.launch.distributed \\
        --coordinator 127.0.0.1:<port> --num-processes 2 --process-id 1

Each rank stitches a global array from the ranks' local slices (an
``all_gather``, the counterpart of the reference's
``make_array_from_process_local_data``) and checks its sum; with
``--exchange-dir`` it then runs one FedAvg round of the TOY task over a
population placed over the ranks and checks that every rank holds the
same global model.  ``--device cpu`` runs the round on the CPU; the
default is the card.
"""
from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist


def find_free_port(host: str = "127.0.0.1") -> int:
    """A free TCP port the OS assigns (for the coordinator of test
    topologies; a production launcher gets the address from its
    scheduler)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, timeout_s: float = 300.0) -> dict:
    """Join the process group at ``coordinator_address`` (``host:port``;
    rank 0 binds it) as rank ``process_id`` of ``num_processes``, on gloo.
    Returns the topology that came up: ``process_id``, ``process_count``."""
    import datetime

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return {"process_id": dist.get_rank(),
            "process_count": dist.get_world_size()}


def placement_from_runtime(exchange_dir: str, **kw):
    """A ``HostPlacement`` for this process's rank in the live group.
    Call after ``initialize``: the host's identity then has one source (a
    rank swapped in argv would swap the shards' owners silently)."""
    from repro_torch.population.placement import HostPlacement

    return HostPlacement(dist.get_rank(), dist.get_world_size(),
                         exchange_dir=exchange_dir, **kw)


def stitch(local: torch.Tensor) -> torch.Tensor:
    """The global array from every rank's equal-sized ``local`` slice, in
    rank order: an ``all_gather`` on gloo (CPU tensors)."""
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.cat(parts)


def fedavg_round(exchange_dir: str, device) -> float:
    """One FedAvg round of the TOY task over a 50-client population placed
    over the group's ranks (shards of 4, a warm cap of 32), each rank
    training its own clients; returns the sum of this rank's final global
    params, which every rank must share."""
    import dataclasses

    from repro_torch.configs.paper import TOY
    from repro_torch.core import algorithms, fl_loop
    from repro_torch.population import Population
    from repro_torch.tree import tree_leaves

    task = dataclasses.replace(TOY, n_clients=50, participation=0.2,
                               rounds=1, local_epochs=1, batch_size=8)
    pop = Population.synthetic(50, warm_cap=32, shard_size=4, min_n=5,
                               max_n=9,
                               placement=placement_from_runtime(exchange_dir))
    hist = fl_loop.run_federated(task, algorithms.make("fedavg"),
                                 population=pop, seed=0, executor="vmap",
                                 width=4, device=device)
    return float(sum(float(p.double().sum())
                     for p in tree_leaves(hist.final_params)))


def _smoke(args) -> int:
    """Initialize, stitch a rank-tagged global array and check its sum on
    every rank; with ``--exchange-dir``, one placed FedAvg round whose
    params every rank must share.  Exit 0: the topology works."""
    info = initialize(args.coordinator, args.num_processes, args.process_id)
    rank, n = info["process_id"], info["process_count"]
    n_local = args.local_size
    local = torch.arange(n_local, dtype=torch.float32) + rank * n_local
    total = float(stitch(local).sum())
    want = float(np.arange(n * n_local, dtype=np.float32).sum())
    print(f"[distributed] rank {rank}/{n} local={n_local} "
          f"global={n * n_local} sum={total} want={want}", flush=True)
    ok = total == want
    if args.exchange_dir:
        mine = fedavg_round(args.exchange_dir, args.device)
        sums = stitch(torch.tensor([mine], dtype=torch.float64)).tolist()
        print(f"[distributed] rank {rank}: FedAvg round params sum {mine!r}, "
              f"every rank's {sums}", flush=True)
        ok = ok and all(s == mine for s in sums)
    dist.destroy_process_group()
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True,
                    help="the group's address, host:port (rank 0 binds it)")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-size", type=int, default=2,
                    help="elements of each rank's slice of the stitched "
                         "array")
    ap.add_argument("--exchange-dir", default=None,
                    help="a directory every rank sees: run one placed "
                         "FedAvg round through it")
    ap.add_argument("--device", default=None,
                    help="the round's torch device; default the CUDA card, "
                         "'cpu' to run on the CPU")
    return _smoke(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
