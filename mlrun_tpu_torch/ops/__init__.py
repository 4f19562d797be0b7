"""Attention and elementwise ops of the PyTorch/CUDA port: ``attention``
(cached flash), ``paged_attention`` (paged decode and prefix prefill),
``rotary``, ``norms``, ``adamw`` (the optimizer's fused update on the
card), and ``_build`` (the CUDA kernels' build and binding)."""
