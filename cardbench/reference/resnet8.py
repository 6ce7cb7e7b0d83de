"""ResNet-8 and its FedGKD rounds, plain PyTorch in fp32.

The model of the paper's CIFAR runs (3 stages of one basic block, GroupNorm
with 16 channels a group, SAME convs padded as JAX pads them), on the
layout of ``frozen.layouts.resnet8_layout`` (NHWC images, HWIO filters),
computed with ``torch.nn.functional``'s convs in NCHW.

``fedgkd_rounds`` replays the first rounds of ``fl_loop.run_federated``
with FedGKD on the same inputs: the cohort and each client's batches drawn
from ``numpy.random.default_rng(seed)`` in the port's order, the teacher
the mean of the last M global models, its logits over each client's shard,
local SGD with momentum and coupled weight decay on CE + (γ/2)·KL, the
aggregation weighted by shard size, and the test set's mean CE and
accuracy.  Clients train one after another.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.frozen import data as fdata
from cardbench.frozen import layouts
from cardbench.frozen.roofline import same_pads
from cardbench.reference import common as C


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    k, h = w.shape[0], x.shape[2]
    _, lo, hi = same_pads(h, k, stride)
    x = F.pad(x, (lo, hi, lo, hi))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.group_norm(x, max(1, x.shape[1] // 16), p["scale"], p["bias"],
                        eps=1e-5)


def _block(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    y = torch.relu(_gn(_conv(x, p["conv1"]["w"], stride), p["gn1"]))
    y = _gn(_conv(y, p["conv2"]["w"], 1), p["gn2"])
    sc = (_conv(x, p["proj"]["w"], stride) if "proj" in p
          else x[:, :, ::stride, ::stride])
    return torch.relu(sc + y)


def apply(p: dict, x_nhwc: torch.Tensor) -> torch.Tensor:
    """Logits (N, classes) of images (N, H, W, C)."""
    x = x_nhwc.permute(0, 3, 1, 2)
    h = torch.relu(_gn(_conv(x, p["stem"]["w"], 1), p["gn0"]))
    h = _block(p["block1"], h, 1)
    h = _block(p["block2"], h, 2)
    h = _block(p["block3"], h, 2)
    return h.mean(dim=(2, 3)) @ p["fc"]["w"] + p["fc"]["b"]


def _logits_in_rows(p: dict, x: torch.Tensor, rows: int = 1024):
    with torch.no_grad():
        return torch.cat([apply(p, x[i:i + rows])
                          for i in range(0, x.shape[0], rows)])


def evaluate(p: dict, x: torch.Tensor, y: torch.Tensor,
             rows: int = 256) -> tuple[float, float]:
    """(accuracy, mean CE) over the test set."""
    logits = _logits_in_rows(p, x, rows)
    return (float((logits.argmax(-1) == y).float().mean()),
            float(C.cross_entropy(logits, y)))


def fedgkd_rounds(init: dict, layout: dict, seed: int, clients: list,
                  test: tuple, *, rounds: int, teacher_rounds: int,
                  cohort: int, batch: int,
                  max_batches: int, epochs: int, lr: float, momentum: float,
                  weight_decay: float, gamma: float, buffer_m: int,
                  device, half_batch: bool = False,
                  loss_scale: float = 1.0, frozen: bool = False,
                  kd_grad: bool = True) -> dict:
    """The readings of ``rounds`` FedGKD rounds from ``init`` (fp32):

    ``loss`` (rounds,): each round's mean over its clients and local steps
    of the step's CE + (γ/2)·KL; ``grad1`` (rounds, K, leaves): the norm
    of each client's first gradient in each round as the optimizer takes
    it (its momentum after one step);
    ``teacher`` (rounds - 1, leaves): the teacher's change from the initial
    weights in rounds 2 on; ``delta`` (leaves,): the global model's change
    after the last round; ``eval_loss``, ``eval_acc`` (rounds,).

    ``half_batch``, ``loss_scale``, ``frozen`` and ``kd_grad`` plant
    faults for the calibration of the limits: half of every batch left out
    (the mean over the rest), every reported loss scaled, every step
    returning its state (parameters and momentum) unchanged, and the KD
    term's gradient dropped (its value kept)."""
    rng = np.random.default_rng(seed)
    n_clients = len(clients)
    test_x = torch.from_numpy(test[0]).to(device)
    test_y = torch.from_numpy(test[1]).to(device)
    glob = init
    buffer = [init]
    out = {"loss": [], "teacher": [], "eval_loss": [], "eval_acc": []}
    for r in range(max(rounds, teacher_rounds)):
        teacher = C.tree_map(lambda *xs: sum(xs[1:], xs[0]) / len(xs),
                             *buffer)
        if r > 0:
            out["teacher"].append(C.change_norms(teacher, layout, seed))
        if r >= rounds:
            break
        cids = fdata.cohort(rng, n_clients, cohort)
        picks = [fdata.client_picks(rng, len(clients[k][1]), batch, epochs,
                                    max_batches) for k in cids]
        acc, total = None, float(sum(len(clients[k][1]) for k in cids))
        losses = []
        for i, k in enumerate(cids):
            x = torch.from_numpy(clients[k][0]).to(device)
            y = torch.from_numpy(clients[k][1]).to(device)
            t_logits = _logits_in_rows(teacher, x)
            p = C.tree_map(torch.clone, glob)
            m = C.tree_map(torch.zeros_like, glob)
            per_step = []
            for s, idx in enumerate(picks[i]):
                idx = torch.from_numpy(idx).to(device)
                if half_batch:
                    idx = idx[: len(idx) // 2]
                live = [t.detach().requires_grad_(True) for t in C.leaves(p)]
                with torch.enable_grad():
                    logits = apply(C.rebuild(p, live), x[idx])
                    kd_in = logits if kd_grad else logits.detach()
                    loss = (C.cross_entropy(logits, y[idx])
                            + 0.5 * gamma * C.kl_rows(t_logits[idx],
                                                      kd_in).mean())
                    grads = torch.autograd.grad(loss, live)
                with torch.no_grad():
                    for pt, mt, g in zip(C.leaves(p), C.leaves(m), grads):
                        if frozen:
                            continue
                        mt.mul_(momentum).add_(g + weight_decay * pt)
                        pt.add_(mt, alpha=-lr)
                if s == 0:
                    out.setdefault("grad1", []).append(C.leaf_norms(m))
                per_step.append(loss.detach() * loss_scale)
            losses.append(torch.stack(per_step))
            w = len(clients[k][1]) / total
            acc = (C.tree_map(lambda t: w * t, p) if acc is None
                   else C.tree_map(lambda a, t: a + w * t, acc, p))
            del p, m, t_logits
        glob = acc
        buffer = (buffer + [glob])[-buffer_m:]
        a, l = evaluate(glob, test_x, test_y)
        out["eval_acc"].append(a)
        out["eval_loss"].append(l)
        out["loss"].append(torch.stack(losses).mean())
    out["delta"] = C.change_norms(glob, layout, seed)
    return {"loss": torch.stack(out["loss"]).cpu(),
            "grad1": torch.stack(out["grad1"]).reshape(
                rounds, cohort, -1).cpu(),
            "teacher": (torch.stack(out["teacher"]).cpu() if out["teacher"]
                        else torch.zeros((0, len(layouts.paths(layout))))),
            "delta": out["delta"].cpu(),
            "eval_loss": torch.tensor(out["eval_loss"]),
            "eval_acc": torch.tensor(out["eval_acc"])}


def readings(init_seed_weights: dict, layout: dict, seed: int, data: dict,
             cfg: dict, traffic: dict, rounds: int, teacher_rounds: int,
             device, precision: str = "fp32",
             fault: Optional[str] = None) -> dict:
    """``fedgkd_rounds`` on the cell's settings, in ``precision``, with an
    optional planted ``fault``: "half_batch", "altered_loss",
    "unchanged", "kd_dropped" (the KD term's gradient dropped, its value
    kept) or "kd_off" (no KD term: γ = 0)."""
    with C.precision(precision):
        return fedgkd_rounds(
            init_seed_weights, layout, seed, data["clients"],
            (data["test_x"], data["test_y"]), rounds=rounds,
            teacher_rounds=teacher_rounds, cohort=traffic["cohort"], batch=traffic["batch"],
            max_batches=traffic["max_batches_per_client"],
            epochs=traffic["local_epochs"], lr=cfg["lr"],
            momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
            gamma=0.0 if fault == "kd_off" else traffic["gamma"],
            buffer_m=traffic["buffer_m"],
            device=device, half_batch=fault == "half_batch",
            loss_scale=1.01 if fault == "altered_loss" else 1.0,
            frozen=fault == "unchanged", kd_grad=fault != "kd_dropped")
