"""The port stands alone: no JAX, nothing of the JAX package, no fallback.

Every ``repro_torch`` module imports with ``jax`` blocked, and loads no
``repro.*`` module; no source line of the port imports either; and the
entry point refuses to run without a card unless asked for the CPU.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)|from\s+repro\s+import)", re.M)


def _port_modules() -> list[str]:
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert {"repro_torch.core.fl_loop", "repro_torch.models.config",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.kernels.ssd_scan.ref", "repro_torch.models.ssm",
            "repro_torch.configs.base", "repro_torch.configs.mamba2_2_7b",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.core.privacy", "repro_torch.core.systemsim",
            "repro_torch.checkpoint.io",
            "repro_torch.checkpoint.recovery"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and (m == 'repro' or m.startswith(('repro.', 'jax'))))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok', len(sys.argv))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_line_imports_jax_or_repro():
    offenders = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
                 for p in PORT.rglob("*.py")
                 for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders
    # the scan itself catches what it must
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import fl_loop")
    assert FORBIDDEN.search("from repro import core")
    assert not FORBIDDEN.search("from repro_torch.core import fl_loop")


def test_run_federated_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs.paper import CIFAR10, scaled
    from repro_torch.core import algorithms, fl_loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = scaled(CIFAR10, 0.01, rounds=1, local_epochs=1)
    data = fl_loop.make_federated_data(task, 0.5, n_test=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fl_loop.run_federated(task, algorithms.make("fedavg"), data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fl_loop.run_federated(task, algorithms.make("fedavg"), data,
                              device="cuda")
    assert fl_loop.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_take_plain_versions_only_on_cpu_tensors():
    """A CPU tensor takes the plain version and counts no launch."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.grouped_conv.ops import client_batched_conv
    from repro_torch.kernels.kd_kl.ops import kd_kl_loss, row_logsumexp
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    reset_launches()
    kd_kl_loss(torch.randn(4, 10), torch.randn(4, 10))
    row_logsumexp(torch.randn(4, 10))
    ssd_scan(torch.randn(1, 5, 2, 4), torch.rand(1, 5, 2), -torch.ones(2),
             torch.randn(1, 5, 1, 4), torch.randn(1, 5, 1, 4), chunk=4)
    client_batched_conv(torch.randn(1, 2, 8, 8, 3), torch.randn(1, 3, 3, 3, 4))
    flash_attention_gqa(torch.randn(1, 5, 2, 8), torch.randn(1, 5, 1, 8),
                        torch.randn(1, 5, 1, 8))
    assert set(LAUNCHES.values()) == {0}
