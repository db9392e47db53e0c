"""Nearest-PSD projection and eigenvalue clipping for Gauss-Newton Hessians
(reference nearest_psd.h:28-99).

PyTorch port of ``deepfactors_tpu/solver/nearest_psd.py``. Frame and
keyframe marginalisation project their Schur complements with it: fp32
round-off on an ill-conditioned eliminated block can push a complement
slightly indefinite.
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


def nearest_psd(A: Tensor, eps: float = 0.0) -> Tensor:
    """Higham projection: symmetrise, then clip negative eigenvalues."""
    return clip_eigenvalues(A, eps)


def is_psd(A: Tensor, tol: float = 0.0) -> Tensor:
    w = torch.linalg.eigvalsh((A + A.transpose(-1, -2)) * 0.5)
    return torch.all(w >= -tol, dim=-1)
