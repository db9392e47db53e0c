"""Robust M-estimator weights (reference sources/common/algorithm/m_estimators.h).

PyTorch port of ``deepfactors_tpu/geometry/m_estimators.py``. Weights apply
to both residual and Jacobian rows (square-root IRLS weighting); branches
are ``torch.where`` so the functions vectorize.
"""
from __future__ import annotations

import math

import torch


def huber_weight(x, delta):
    """sqrt(delta(2|x|-delta))/|x| outside the delta band (m_estimators.h:50-56)."""
    aa = torch.abs(x)
    safe = torch.clamp(aa, min=1e-12)
    w = torch.sqrt(delta * (2.0 * aa - delta)) / safe
    return torch.where(aa <= delta, torch.ones_like(w), w)


def cauchy_weight(x, delta):
    """(m_estimators.h:42-48)."""
    safe_x = torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)
    a = delta / safe_x
    return torch.abs(a) / math.sqrt(2.0) * torch.sqrt(torch.log1p(1.0 / (a * a)))


def tukey_weight(x, delta):
    """(m_estimators.h:26-40)."""
    safe_x = torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)
    a = delta / safe_x
    first = 1.0 - 1.0 / (a * a)
    inside = torch.abs(a) * torch.sqrt(torch.clamp(1.0 - first**3, min=0.0) / 6.0)
    outside = torch.abs(a) * math.sqrt(1.0 / 6.0)
    return torch.where(torch.abs(safe_x) <= delta, inside, outside)


def tukey_sqrt_weight(x, c):
    """Tukey biweight as a square-root IRLS weight: w = max(0, 1-(x/c)²),
    effective weight w² = biweight. Redescending: residuals beyond c get
    exactly zero weight. Use at the finest pyramid level only (see
    MapperConfig.fine_loss)."""
    a = x / c
    return torch.clamp(1.0 - a * a, min=0.0)
