"""``correct`` on the CPU at a small size: each entry against the
reference passes under the cell's limits; with the port broken underneath
(a step that returns its state unchanged, half of every batch left out,
the loss altered where a step produces it, the KD term's gradient
dropped or the term left out) the run comes out not correct;
and the control, the reference one precision below the configuration's
in the port's place, fails a limit (TF32 needs the card)."""
import pytest
import torch

import cells
from cardbench import harness
from cardbench.reference import compare

CELLS = ("resnet8-cifar10.fedgkd", "phi4-mini.fedgkd")
SEED = 2 ** 35 + 19


def _cell(name, monkeypatch):
    cell = cells.small_cell(name)
    if cell.workload["entry"] == "run_serial":
        cells.patch_lm_config(monkeypatch, cell)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_entry_agrees_with_reference(name, monkeypatch):
    result = harness.run_cell(_cell(name, monkeypatch), SEED, 0.5, False,
                              "cpu")
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert {"round_s", "peak_gib", "setup_s"} <= set(result["metrics"])


def _broken_step(kind):
    """A wrapper for the port's step factory that plants ``kind``."""
    def make(real):
        def factory(*a, **kw):
            step = real(*a, **kw)

            def lm(params, teacher, opt_state, batch):
                if kind == "half_batch":
                    half = batch["tokens"].shape[0] // 2
                    batch = {k: v[:half] for k, v in batch.items()}
                p, o, m = step(params, teacher, opt_state, batch)
                if kind == "unchanged":
                    return params, opt_state, m
                if kind == "altered_loss":
                    m = dict(m, loss=m["loss"] * 1.01)
                return p, o, m

            def cv(params, opt_state, payload, states, x, y, mask, aux, lr):
                if kind == "half_batch":
                    h = x.shape[1] // 2
                    x, y, mask = x[:, :h], y[:, :h], mask[:, :h]
                    aux = {k: v[:, :h] for k, v in aux.items()}
                p, o, loss, per = step(params, opt_state, payload, states, x,
                                       y, mask, aux, lr)
                if kind == "unchanged":
                    return params, opt_state, loss, per
                if kind == "altered_loss":
                    per = per * 1.01
                return p, o, loss, per

            return lm if "cfg" in kw or (a and hasattr(a[0], "d_model")) \
                else cv
        return factory
    return make


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered_loss"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_port_is_not_correct(name, kind, monkeypatch):
    cell = _cell(name, monkeypatch)
    if cell.workload["entry"] == "run_serial":
        from repro_torch.launch import steps as owner
        attr = "make_train_step"
    else:
        from repro_torch.core import client as owner
        attr = "make_step"
    monkeypatch.setattr(owner, attr, _broken_step(kind)(getattr(owner, attr)))
    result = harness.run_cell(cell, SEED, 0.5, False, "cpu")
    assert not result["correct"], result["checks"]


def _kd(kind):
    """The port's KL (``core.distillation.kl_divergence``, B1/B2) with its
    gradient dropped and its value kept, or left out."""
    from repro_torch.core import distillation

    real = distillation.kl_divergence

    def kl(t, s, *a, **kw):
        if kind == "kd_dropped":
            return real(t, s.detach(), *a, **kw)
        return torch.zeros(s.shape[:-1], device=s.device)
    return distillation, kl


@pytest.mark.parametrize("name,kind", [
    ("resnet8-cifar10.fedgkd", "kd_dropped"),
    ("resnet8-cifar10.fedgkd", "kd_off"),
    ("phi4-mini.fedgkd", "kd_off")])
def test_a_port_without_its_kd_is_not_correct(name, kind, monkeypatch):
    """The KD term's gradient dropped where the port's loss takes it, or the
    term left out.  (The LM's KD gradient is nought to rounding in its
    compared rounds; only its value, the KD reading, shows there.)"""
    cell = _cell(name, monkeypatch)
    owner, kl = _kd(kind)
    monkeypatch.setattr(owner, "kl_divergence", kl)
    result = harness.run_cell(cell, SEED, 0.5, False, "cpu")
    assert not result["correct"], result["checks"]


def test_fp8_control_fails_the_lm_cell(monkeypatch):
    cell = _cell("phi4-mini.fedgkd", monkeypatch)
    run = harness.Run(cell, SEED, 0.0, False, torch.device("cpu"), 0.0)
    entry = cell.entry
    state = entry.prepare(run)
    ref = entry.reference(run, state)
    got = entry.reference(run, state, precision="fp8")
    gaps = compare.gaps(got, ref)
    limits = cell.workload["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.gpu
def test_tf32_control_fails_the_cv_cell(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    cell = _cell("resnet8-cifar10.fedgkd", monkeypatch)
    run = harness.Run(cell, SEED, 0.0, False, torch.device("cuda"), 0.0)
    entry = cell.entry
    state = entry.prepare(run)
    ref = entry.reference(run, state)
    got = entry.reference(run, state, precision="tf32")
    gaps = compare.gaps(got, ref)
    limits = cell.workload["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.parametrize("name", CELLS)
def test_calibration_reads_every_fault(name, monkeypatch, capsys):
    """``calibrate.py`` at a small size: the port's numbers, the
    reference's loss and KD, and each planted fault, one JSON line each
    (the controls: the tests above)."""
    import json

    from cardbench import calibrate

    cell = _cell(name, monkeypatch)
    what = list(calibrate.FAULTS)
    assert calibrate.main(["--workload", name, "--program-seeds", "5",
                           "--seeds", str(SEED), "--what", *what],
                          cell=cell, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["reading"] for x in lines] == ["program", "reference", *what]
    assert lines[0]["correct"]
    limits = cell.workload["limits"]
    for x in lines[2:]:
        if x["reading"] != "kd_dropped" or name.startswith("resnet8"):
            assert any(x["gaps"][k] > limits[k] for k in limits), x
