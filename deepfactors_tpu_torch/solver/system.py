"""Dense block assembly + damped solving for factor-graph MAP inference.

PyTorch port of ``deepfactors_tpu/solver/system.py`` (the replacement for
GTSAM's HessianFactor elimination, mapper.cpp:517-533,
photometric_factor.cpp:135-161). Variables live in fixed-capacity blocks
([poses 6K | codes CS·K | frame poses 6F]); each factor contributes a dense
system plus the global indices of its variables; assembly is one
scatter-add; the solve eliminates the per-keyframe code blocks by Schur
complement. Cholesky factorisations use ``torch.linalg.cholesky_ex``: a
non-positive-definite block yields NaN (the JAX semantics) instead of
raising and syncing with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class GlobalSystem(NamedTuple):
    H: Tensor  # [D, D]
    b: Tensor  # [D]  (gradient: Jtr)


def factor_slot_indices(idx0: Tensor, idx1: Tensor, K: int, CS: int) -> Tensor:
    """Global variable indices [..., 12 + CS] of photometric factors
    (pose0, pose1, code0): poses at [0, 6K), code i at 6K + i·CS."""
    dev = idx0.device
    pose0 = idx0[..., None] * 6 + torch.arange(6, device=dev)
    pose1 = idx1[..., None] * 6 + torch.arange(6, device=dev)
    code0 = 6 * K + idx0[..., None] * CS + torch.arange(CS, device=dev)
    return torch.cat([pose0, pose1, code0], dim=-1).long()


def assemble(D: int, factor_H: Tensor, factor_b: Tensor, factor_idx: Tensor,
             factor_active: Tensor) -> GlobalSystem:
    """Sum factor systems into a global dense system H = Σ EᵀH_fE (one
    scatter-add; overlapping indices accumulate). Inactive factors are
    masked with a select, so NaN in an inactive slot cannot leak."""
    on = factor_active.bool()
    Hf = torch.where(on[:, None, None], factor_H, torch.zeros_like(factor_H))
    bf = torch.where(on[:, None], factor_b, torch.zeros_like(factor_b))
    idx = factor_idx.long()
    H = torch.zeros((D, D), dtype=factor_H.dtype, device=factor_H.device)
    b = torch.zeros((D,), dtype=factor_b.dtype, device=factor_b.device)
    rows = idx[:, :, None].expand(Hf.shape)
    cols = idx[:, None, :].expand(Hf.shape)
    H.index_put_((rows.reshape(-1), cols.reshape(-1)), Hf.reshape(-1),
                 accumulate=True)
    b.index_add_(0, idx.reshape(-1), bf.reshape(-1))
    return GlobalSystem(H, b)


def add_diagonal_prior(sys: GlobalSystem, idx: Tensor, weight: Tensor,
                       residual: Tensor) -> GlobalSystem:
    """Gaussian prior on variables at ``idx``: H += w·I, b += w·r
    (df_work.cpp:29-57)."""
    weight = torch.as_tensor(weight, dtype=sys.H.dtype,
                             device=sys.H.device).expand(idx.shape)
    H = sys.H.index_put((idx, idx), weight, accumulate=True)
    b = sys.b.index_put((idx,), weight * residual, accumulate=True)
    return GlobalSystem(H, b)


def mask_inactive(sys: GlobalSystem, active_mask: Tensor) -> GlobalSystem:
    """Pin inactive variable slots: zero their rows/cols and put 1 on the
    diagonal so the Cholesky stays well-posed and their update is 0."""
    m = active_mask.to(sys.H.dtype)
    H = sys.H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    return GlobalSystem(H, sys.b * m)


def _cholesky(A: Tensor) -> Tensor:
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def solve_damped(sys: GlobalSystem, lam) -> Tensor:
    """Levenberg-Marquardt step: solve (H + lam·diag(H) + eps·I) dx = -b."""
    A = sys.H + torch.diag(lam * torch.diagonal(sys.H) + 1e-8)
    return -torch.cholesky_solve(sys.b[:, None], _cholesky(A))[:, 0]


def solve_schur_codes(sys: GlobalSystem, K: int, CS: int, lam) -> Tensor:
    """Solve eliminating the per-keyframe code blocks by Schur complement.

    Layout [poses 6K | codes CS·K | frame poses 6F]. The code block C is
    block-diagonal [K, CS, CS] (a photometric factor touches one code):

        S  = A_xx − A_xc C⁻¹ A_cx      over x = [poses | frames]
        dx = −S⁻¹ (b_x − A_xc C⁻¹ b_c)
        dc = −C⁻¹ (b_c + A_cx dx)

    with one batched Cholesky over the K code blocks."""
    Dp, Dc = 6 * K, CS * K
    H = sys.H + torch.diag(lam * torch.diagonal(sys.H) + 1e-8)
    xs = torch.cat([torch.arange(Dp, device=H.device),
                    torch.arange(Dp + Dc, H.shape[0], device=H.device)])
    Axx = H[xs[:, None], xs]
    Axc = H[xs, Dp:Dp + Dc]                                    # [Dx, Dc]
    bx = sys.b[xs]
    bc = sys.b[Dp:Dp + Dc]
    Dx = xs.shape[0]
    C = H[Dp:Dp + Dc, Dp:Dp + Dc].reshape(K, CS, K, CS)
    k = torch.arange(K, device=H.device)
    Cd = C[k, :, k, :]                                          # [K, CS, CS]
    Lc = _cholesky(Cd)
    U = torch.cat([Axc.T.reshape(K, CS, Dx), bc.reshape(K, CS, 1)], dim=-1)
    X = torch.cholesky_solve(U, Lc)                             # [K, CS, Dx+1]
    CinvAcx = X[..., :Dx]
    Cinv_bc = X[..., Dx]
    Axc_b = Axc.reshape(Dx, K, CS)
    S = Axx - torch.einsum("pkc,kcq->pq", Axc_b, CinvAcx)
    rhs = bx - torch.einsum("pkc,kc->p", Axc_b, Cinv_bc)
    dx = -torch.cholesky_solve(rhs[:, None], _cholesky(S))[:, 0]
    dc = -(Cinv_bc + torch.einsum("kcp,p->kc", CinvAcx, dx))
    return torch.cat([dx[:Dp], dc.reshape(-1), dx[Dp:]])
