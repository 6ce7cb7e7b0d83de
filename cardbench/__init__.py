"""The benchmark of the PyTorch port (``repro_torch``) on one NVIDIA H100.

``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything that belongs to one cell, configuration, entry, traffic
mix or per-layer metric is a file of its own, found by its name:

    configs/<config>.json      the model and its training settings
    traffic/<traffic>.json     the rounds' work: cohort, local steps, data
    workloads/<cell>.json      config + traffic + entry, warm-up, limits
    entries/<entry>.py         how a cell of that kind drives the port
    metrics/<metric>.py        one per-layer metric's reader
    reference/                 the plain fp32 reference (no repro_torch)
    frozen/                    the yardstick: peaks, costs, generators

Nothing here imports ``jax``, the JAX package ``repro``, ``chip_smoke`` or
``tools``; ``reference/`` and ``frozen/`` import nothing of ``repro_torch``.
"""
