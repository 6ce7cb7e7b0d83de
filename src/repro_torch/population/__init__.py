"""Population tier: an out-of-core client store and O(cohort) sampling.

The port of ``repro.population``: millions of registered clients with
host memory bounded by a warm-tier cap instead of the population's size.
``population.py`` holds the facade the FL loop takes, ``sources.py`` the
cold tier, ``store.py`` the warm and state tiers, ``sampling.py`` the
two-stage cohort draw and ``placement.py`` the ownership of shards by hosts
with the filesystem exchange between them.
"""
from repro_torch.population.placement import (HostPlacement, allgather,
                                              allgather_partial,
                                              clear_host_payloads,
                                              confirm_resume, peak_rss_mb,
                                              resume_barrier)
from repro_torch.population.population import Population
from repro_torch.population.sampling import HierarchicalSampler, shift_positions
from repro_torch.population.sources import (ClientSource, DiskShardSource,
                                            InMemorySource,
                                            SyntheticClientSource,
                                            even_shard_sizes,
                                            write_population_shards)
from repro_torch.population.store import ClientStateStore, PopulationStore

__all__ = [
    "Population", "HierarchicalSampler", "shift_positions", "ClientSource",
    "DiskShardSource", "InMemorySource", "SyntheticClientSource",
    "even_shard_sizes", "write_population_shards", "ClientStateStore",
    "PopulationStore", "HostPlacement", "allgather", "allgather_partial",
    "resume_barrier", "confirm_resume", "clear_host_payloads",
    "peak_rss_mb",
]
