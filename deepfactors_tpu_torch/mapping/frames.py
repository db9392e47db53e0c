"""One-way frame storage (SoA, fixed capacity).

PyTorch port of ``deepfactors_tpu/mapping/frames.py`` (reference Frame,
frame.h:35-120): image + gradient pyramids and an auxiliary SE(3) pose
variable, used as photometric targets and later marginalised
(mapper.cpp:395-436). ``add_frame`` writes the pools in place.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..geometry import se3 as se3m
from ..geometry.se3 import SE3

Tensor = torch.Tensor


class FrameLevel(NamedTuple):
    img: Tensor   # [F, H, W]
    grad: Tensor  # [F, H, W, 2]


class FrameStore(NamedTuple):
    active: Tensor        # [F] bool — holds data & a live pose variable
    marginalized: Tensor  # [F] bool
    ids: Tensor           # [F] int32
    pose: SE3             # [F]
    levels: tuple         # tuple[FrameLevel]
    next_id: Tensor


def create(F: int, H: int, W: int, num_levels: int, device="cuda") -> FrameStore:
    levels = tuple(
        FrameLevel(
            img=torch.zeros((F, H >> l, W >> l), device=device),
            grad=torch.zeros((F, H >> l, W >> l, 2), device=device))
        for l in range(num_levels))
    return FrameStore(
        active=torch.zeros((F,), dtype=torch.bool, device=device),
        marginalized=torch.zeros((F,), dtype=torch.bool, device=device),
        ids=torch.full((F,), -1, dtype=torch.int32, device=device),
        pose=se3m.identity((F,), device=device),
        levels=levels,
        next_id=torch.zeros((), dtype=torch.int32, device=device),
    )


def add_frame(store: FrameStore, slot: int, pose: SE3,
              img_pyr: Sequence[Tensor], grad_pyr: Sequence[Tensor]) -> FrameStore:
    for l, lvl in enumerate(store.levels):
        lvl.img[slot] = img_pyr[l]
        lvl.grad[slot] = grad_pyr[l]
    store.active[slot] = True
    store.marginalized[slot] = False
    store.ids[slot] = store.next_id
    store.pose.q[slot] = pose.q
    store.pose.t[slot] = pose.t
    store.next_id.add_(1)
    return store
