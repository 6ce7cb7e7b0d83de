"""PyTorch port of the FedGKD reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``repro_torch.core.fl_loop`` is the counterpart of
``repro.core.fl_loop``) and imports neither ``jax`` nor ``repro``.

Conventions kept from the reference so one set of numpy arrays feeds both:

* parameters are plain nested dicts of tensors with the JAX pytree's keys;
  a cohort trains CLIENT-STACKED parameters, every leaf ``(K, ...)``;
* activations are NHWC, conv weights HWIO, dense weights ``(in, out)``;
* cohorts and batch picks come from numpy ``default_rng`` in the
  reference's order, so one seed samples the same clients and batches.

Every device is explicit: the entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``.  Every random draw goes through an explicit
``torch.Generator``.  The hand-written CUDA kernels (``repro_torch.csrc``)
are built at first use on the card; on a CPU tensor each kernel wrapper
takes its plain PyTorch version instead.
"""
