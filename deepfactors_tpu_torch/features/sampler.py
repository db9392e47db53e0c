"""Uniform pixel sampling for the sparse geometric factor (reference
sources/core/gtsam/uniform_sampler.cpp, mt19937-based; fixed N, resampled
per relinearisation when enabled, sparse_geometric_factor.cpp:153-157).

PyTorch port of ``deepfactors_tpu/features/sampler.py``. The JAX package
draws from ``jax.random``; here the draws come from an explicit
``torch.Generator``, so the same seed gives other points than JAX's (a
test replays JAX's draws through the mapper's ``geo_draw`` hook).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def sample_uniform_pixels(n: int, width: int, height: int, border: int = 1,
                          generator: torch.Generator = None) -> Tensor:
    """[n, 2] float32 (x, y) pixel coordinates on the generator's device:
    x uniform in [border, width - 1 - border), y in [border,
    height - 1 - border)."""
    dev = generator.device if generator is not None else "cpu"

    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, device=dev)
        return lo + u * (hi - lo)

    x = uniform(float(border), float(width - 1 - border))
    y = uniform(float(border), float(height - 1 - border))
    return torch.stack([x, y], dim=-1)
