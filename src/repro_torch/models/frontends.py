"""Modality-frontend stubs for the audio and vision architectures.

The port of ``repro.models.frontends``.  As in the reference, the conv/mel
codec (audio) and the ViT/SigLIP tower (vision) are not implemented: the
backbone is handed precomputed frame or patch embeddings of the right
shape.  These helpers give those shapes and draw deterministic synthetic
embeddings for smoke runs.

Geometries (fixed per family, the reference's):
  * audio (SeamlessM4T's w2v-BERT codec): a frame every 80 ms, so a 30 s
    clip is 375 frames, rounded up to 384;
  * vision (LLaVA-NeXT's anyres): 576 base patches (24 x 24 at
    CLIP-L/14, 336 px), up to 4 tiles more.
The smoke configs use ``SMOKE_FRONTEND_SEQ`` positions.
"""
from __future__ import annotations

import torch

AUDIO_FRAMES = 384
VLM_PATCHES = 576
SMOKE_FRONTEND_SEQ = 16


def frontend_seq(frontend: str) -> int:
    return {"audio": AUDIO_FRAMES, "vision": VLM_PATCHES}[frontend]


def synth_embeddings(generator: torch.Generator, batch: int, seq: int,
                     d_model: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A stand-in for a frontend's output: standard normal draws on
    ``generator``'s device scaled to unit RMS over d_model, (batch, seq,
    d_model) in ``dtype``.  (The reference draws from ``jax.random``;
    parity tests feed both packages the same numpy-made embeddings.)"""
    x = torch.randn((batch, seq, d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    x = x / torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                       + 1e-6)
    return x.to(dtype)
