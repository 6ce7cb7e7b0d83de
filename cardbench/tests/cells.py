"""Small cells for the CPU tests: the benchmark's own cells with their
files, cut to sizes a CPU run holds in seconds."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from cardbench import harness  # noqa: E402

# the LM at a CPU size in fp32, as the port's smoke configs are: the CPU's
# bf16 products round otherwise than the card's
SMALL_LM = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=211,
                param_dtype="float32", activation_dtype="float32")


def small_cell(name: str, **limits) -> harness.Cell:
    """``name`` as ``BENCHMARK.json`` has it, at a CPU size, with its
    limits (or those given)."""
    cell = harness.load_cell(name)
    cell = copy.deepcopy(cell)
    cfg, tr, wl = cell.config, cell.traffic, cell.workload
    if cell.workload["entry"] == "fl_loop":
        cfg.update(n_clients=4, train_size=4 * 48, test_size=40, image_hw=16)
        tr.update(cohort=2, batch=16, max_batches_per_client=3)
        wl.update(warmup_rounds=2, profile_rounds=1)
    else:
        cfg.update(SMALL_LM)
        tr.update(clients=2, batches_per_round=2, batch=2, seq=17)
        wl.update(profile_rounds=1)
    wl["limits"].update(limits)
    return cell


def patch_lm_config(monkeypatch, cell: harness.Cell) -> None:
    """The port's registry gives the small sizes of ``cell``'s config."""
    from repro_torch import configs

    real = configs.get_config
    sizes = {k: cell.config[k] for k in SMALL_LM}
    monkeypatch.setattr(configs, "get_config",
                        lambda name: real(name).replace(**sizes))
