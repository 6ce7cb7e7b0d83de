"""Batched serving: prefill and greedy decode over a queue of requests.

The port of ``repro.launch.serve``: requests arrive with prompts and are
served in waves of ``batch``; each wave gets a fresh float32 cache, its
prompts left-padded with token 0 to the wave's longest and prefilled
through the decode step one position at a time, then ``gen`` tokens are
decoded greedily (``argmax``).  ``decode_steps`` counts the prefill
positions and the ``gen - 1`` decode calls of each wave, and ``tok_per_s``
is ``decode_steps * batch`` over the host's seconds around the whole run
(after a ``torch.cuda.synchronize()`` on a card).  Decode is plain
PyTorch, as in the reference, which computes it outside any Pallas kernel.

Runs on ``"cuda"`` unless the caller passes ``device="cpu"`` (``--device
cpu``); without a card and without that it raises rather than fall back.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --smoke --requests 8 --batch 4 --gen 16 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.fl_loop import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer
from repro_torch.tree import tree_leaves, tree_map


class ServeLoop:
    """Serves prompts with ``params`` on their device; ``max_len`` slots of
    KV cache a wave.  Each wave's cache is float32 whatever the model's
    dtypes, as the reference's ``run`` asks for it (``init_cache``'s own
    default is bf16).  (The reference's ``__init__`` also takes a cache
    dtype for a cache it allocates and never reads; the port makes only
    the cache of each wave.)"""

    def __init__(self, cfg, params, batch: int, max_len: int):
        self.cfg, self.params = cfg, params
        self.batch, self.max_len = batch, max_len
        self.device = tree_leaves(params)[0].device
        self.decode = make_serve_step(cfg)

    def run(self, prompts: list[np.ndarray], gen: int) -> dict:
        """Serve all prompts: {"outputs": {request: tokens}, "seconds",
        "decode_steps", "tok_per_s"}."""
        queue = list(enumerate(prompts))
        outputs: dict[int, list[int]] = {}
        n_steps = 0
        self._sync()
        t0 = time.perf_counter()
        while queue:
            wave, queue = queue[: self.batch], queue[self.batch:]
            # a fresh cache per wave (batch-synchronous serving)
            cache = transformer.init_cache(self.cfg, self.batch, self.max_len,
                                           torch.float32, device=self.device)
            plen = max(len(p) for _, p in wave)
            toks = np.zeros((self.batch, plen), np.int32)
            for i, (_, p) in enumerate(wave):
                toks[i, plen - len(p):] = p           # left-pad
            toks = torch.from_numpy(toks).to(self.device)
            logits = None
            for i in range(plen):                      # prefill via decode
                logits, cache = self.decode(self.params, cache,
                                            toks[:, i:i + 1])
                n_steps += 1
            tok = torch.argmax(logits[:, -1:], dim=-1)
            gen_toks = [tok]
            for _ in range(gen - 1):
                logits, cache = self.decode(self.params, cache, tok)
                tok = torch.argmax(logits[:, -1:], dim=-1)
                gen_toks.append(tok)
                n_steps += 1
            out = torch.cat(gen_toks, dim=1).cpu().numpy()
            for i, (rid, _) in enumerate(wave):
                outputs[rid] = out[i].tolist()
        self._sync()
        dt = time.perf_counter() - t0
        return {"outputs": outputs, "seconds": dt, "decode_steps": n_steps,
                "tok_per_s": n_steps * self.batch / max(dt, 1e-9)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_prompts(n: int, vocab: int, prompt_len: int,
                 seed: int = 0) -> list[np.ndarray]:
    """``n`` prompts of 4 to ``prompt_len`` tokens, drawn as the reference's
    CLI draws them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, prompt_len + 1))
            .astype(np.int32) for _ in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card, 'cpu' to run "
                         "on the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = tree_map(lambda t: t.to(dev), transformer.init(
        torch.Generator().manual_seed(0), cfg))
    prompts = make_prompts(args.requests, cfg.vocab_size, args.prompt_len)
    loop = ServeLoop(cfg, params, args.batch, args.prompt_len + args.gen + 1)
    stats = loop.run(prompts, args.gen)
    print(f"served {args.requests} requests in {stats['seconds']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s, batch={args.batch})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
