"""Eigenvalue clipping for Gauss-Newton Hessians (reference
nearest_psd.h:28-99).

PyTorch port of ``clip_eigenvalues`` from
``deepfactors_tpu/solver/nearest_psd.py`` — the part frame marginalisation
uses. ``nearest_psd`` and ``is_psd`` come with the keyframe-eviction slice.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def clip_eigenvalues(A: Tensor, min_eig: float = 0.0) -> Tensor:
    """Clamp eigenvalues of a symmetric matrix [..., D, D] from below.
    Non-finite entries are zeroed first: a non-finite Hessian carries no
    usable information and would poison the eigensolver."""
    A = torch.where(torch.isfinite(A), A, torch.zeros_like(A))
    w, V = torch.linalg.eigh((A + A.transpose(-1, -2)) * 0.5)
    w = torch.clamp(w, min=min_eig)
    return torch.einsum("...ij,...j,...kj->...ik", V, w, V)
