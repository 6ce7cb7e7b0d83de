"""The command refuses to measure without the cell's card, and fails in a
directory that holds only ``BENCHMARK.json`` and the benchmark's files:
no result line either way."""
import os
import shutil
import subprocess
import sys

import cells

ROOT = cells.ROOT
ARGS = ["--workload", "resnet8-cifar10.fedgkd", "--seed", str(2 ** 40 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "cardbench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    # past the look for a card, the run stops where it needs the port
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    drive = ("import sys; sys.path[:0] = ['.']; from cardbench import harness;"
             " c = harness.load_cell('resnet8-cifar10.fedgkd');"
             " print(harness.run_cell(c, 3, 1.0, False, 'cpu'))")
    out = subprocess.run([sys.executable, "-c", drive], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'repro_torch'" in out.stderr
