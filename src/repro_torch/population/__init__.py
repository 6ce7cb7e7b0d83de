"""Population tier: an out-of-core client store and O(cohort) sampling.

The port of ``repro.population`` for one host: millions of registered
clients with host memory bounded by a warm-tier cap instead of the
population's size.  ``population.py`` holds the facade the FL loop takes,
``sources.py`` the cold tier, ``store.py`` the warm and state tiers,
``sampling.py`` the two-stage cohort draw and ``placement.py`` the
single-host part of the placement (more hosts: ROADMAP A13).
"""
from repro_torch.population.placement import HostPlacement, peak_rss_mb
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
    "PopulationStore", "HostPlacement", "peak_rss_mb",
]
