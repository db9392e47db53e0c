"""Marginal priors: information-preserving frame marginalisation.

PyTorch port of ``deepfactors_tpu/mapping/marginal.py``. When a one-way
frame is marginalised (the reference's ISAM2 ``marginalizeLeaves``,
mapper.cpp:395-436), its photometric factor is linearised once more, the
frame-pose block is eliminated by Schur complement, and the resulting
quadratic prior over the keyframe's (pose, code) — anchored at the current
estimate — is accumulated into a per-keyframe store that every mapping
iteration adds to the global system.

Prior model per keyframe k (D = 6 + CS):
    E(x) = 0.5 * r^T H r + b^T r,  r = [local(anchor_pose, pose); code - anchor_code]

``add_prior`` / ``add_prior_masked`` / ``clear`` update the store IN PLACE
(the JAX package rebuilt it immutably).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m
from ..geometry.se3 import SE3
from ..solver.nearest_psd import clip_eigenvalues

Tensor = torch.Tensor


class MarginalStore(NamedTuple):
    H: Tensor         # [K, D, D]
    b: Tensor         # [K, D]
    anchor_q: Tensor  # [K, 4]
    anchor_t: Tensor  # [K, 3]
    anchor_c: Tensor  # [K, CS]
    active: Tensor    # [K] bool


def create(K: int, CS: int, device="cuda") -> MarginalStore:
    D = 6 + CS
    ident = se3m.identity((K,), device=device)
    return MarginalStore(
        H=torch.zeros((K, D, D), device=device),
        b=torch.zeros((K, D), device=device),
        anchor_q=ident.q, anchor_t=ident.t,
        anchor_c=torch.zeros((K, CS), device=device),
        active=torch.zeros((K,), dtype=torch.bool, device=device),
    )


def schur_marginalize_frame(JtJ: Tensor, Jtr: Tensor, CS: int,
                            damping=1e-6):
    """Eliminate the frame-pose block from photometric factor systems
    [..., 12+CS, 12+CS] with layout [pose_kf(6) | pose_frame(6) |
    code_kf(CS)]. Returns (H_kk [..., 6+CS, 6+CS], b_k [..., 6+CS]),
    PSD-projected (f32 roundoff on an ill-conditioned frame block can push
    the complement slightly indefinite)."""
    dev = JtJ.device
    keep = torch.cat([torch.arange(6, device=dev),
                      12 + torch.arange(CS, device=dev)])
    elim = 6 + torch.arange(6, device=dev)
    Hkk = JtJ[..., keep[:, None], keep]
    Hke = JtJ[..., keep[:, None], elim]
    Hee = JtJ[..., elim[:, None], elim] + damping * torch.eye(6, device=dev)
    Hee_inv = torch.linalg.inv(Hee)
    HkeHinv = Hke @ Hee_inv
    H_marg = Hkk - HkeHinv @ Hke.transpose(-1, -2)
    b_marg = Jtr[..., keep] - (HkeHinv @ Jtr[..., elim, None])[..., 0]
    return clip_eigenvalues(H_marg), b_marg


def clear(store: MarginalStore, slot) -> MarginalStore:
    """Drop the marginal prior of an evicted slot."""
    store.H[slot] = 0.0
    store.b[slot] = 0.0
    store.active[slot] = False
    return store


def add_prior(store: MarginalStore, slot, H: Tensor, b: Tensor,
              pose: SE3, code: Tensor) -> MarginalStore:
    """Accumulate a marginal prior for keyframe ``slot`` anchored at the
    current (pose, code). An existing prior at an older anchor is
    re-anchored first: its gradient is transported to the new point
    (b_old' = H_old·r + b_old, H kept)."""
    return add_prior_masked(store, slot, H, b, pose, code, True)


def add_prior_masked(store: MarginalStore, slot, H: Tensor, b: Tensor,
                     pose: SE3, code: Tensor, on) -> MarginalStore:
    """``add_prior`` gated by ``on`` (bool or 0-d bool tensor) — a no-op
    when off, without a host sync."""
    on = torch.as_tensor(on, device=store.H.device)
    old_anchor = SE3(store.anchor_q[slot], store.anchor_t[slot])
    r = torch.cat([se3m.local(old_anchor, pose), code - store.anchor_c[slot]])
    w = store.active[slot].to(store.b.dtype)
    b_shift = w * (store.H[slot] @ r)
    sel = lambda new, old: torch.where(on, new, old)
    store.H[slot] = sel(store.H[slot] + H, store.H[slot])
    store.b[slot] = sel(store.b[slot] + b + b_shift, store.b[slot])
    store.anchor_q[slot] = sel(pose.q, store.anchor_q[slot])
    store.anchor_t[slot] = sel(pose.t, store.anchor_t[slot])
    store.anchor_c[slot] = sel(code, store.anchor_c[slot])
    store.active[slot] = sel(torch.ones_like(on), store.active[slot])
    return store


def prior_terms(store: MarginalStore, poses: SE3, codes: Tensor):
    """Batched prior contributions at the current estimate: (H [K, D, D],
    g [K, D]) with g = H r + b; inactive slots contribute zero."""
    anchors = SE3(store.anchor_q, store.anchor_t)
    r = torch.cat([se3m.local(anchors, poses), codes - store.anchor_c], dim=-1)
    g = torch.einsum("kij,kj->ki", store.H, r) + store.b
    w = store.active.to(torch.float32)
    return store.H * w[:, None, None], g * w[:, None]
