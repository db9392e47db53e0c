"""Struct-of-arrays keyframe map with fixed capacity and active masks.

PyTorch port of ``deepfactors_tpu/mapping/map_state.py`` (reference
keyframe_map.h:31-129, keyframe.h:33-97): all keyframe state lives in dense
[K, ...] device tensors; "allocation" flips an active flag.

Unlike the JAX package (immutable arrays, every write rebuilds the state),
``add_keyframe``, ``update_depth_all``, ``add_link`` and ``remove_link``
write the pools IN PLACE and return the same state object. The level-0
depth gradient (``dpt_grad``, read by the geometric factor) is written at
``add_keyframe`` from the keyframe's code at that moment and only there,
as in the JAX package: it is not refreshed when the code moves. Keypoint
descriptors are ``int32`` words holding the bits of the JAX package's
``uint32`` ones (features/detector.py).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..geometry import se3 as se3m
from ..geometry import warping as wp
from ..geometry.se3 import SE3
from ..ops import image as ip

Tensor = torch.Tensor


class LevelData(NamedTuple):
    """Per-pyramid-level keyframe tensors, each [K, H_l, W_l, ...]."""

    img: Tensor    # [K, H, W]
    grad: Tensor   # [K, H, W, 2]
    prx0: Tensor   # [K, H, W] zero-code proximity
    jac: Tensor    # [K, CS, H, W] code Jacobian, feature-major
    stdev: Tensor  # [K, H, W] log-b uncertainty
    dpt: Tensor    # [K, H, W] materialised depth
    vld: Tensor    # [K, H, W] validity


class MapState(NamedTuple):
    """The keyframe map. Capacity K static; ``active`` masks live slots."""

    active: Tensor   # [K] bool
    ids: Tensor      # [K] int32
    pose: SE3        # q [K, 4], t [K, 3] — camera-to-world
    code: Tensor     # [K, CS]
    levels: tuple    # tuple[LevelData], finest first
    # undirected link table (keyframe_map.h links), stored directed per slot
    link_src: Tensor     # [Lmax] int32 slot index
    link_dst: Tensor     # [Lmax] int32 slot index
    link_active: Tensor  # [Lmax] bool
    next_id: Tensor  # [] int32
    # sparse features (Frame::features, frame.h:104), fixed capacity per kf
    kp_xy: Tensor     # [K, Kp, 2]
    kp_desc: Tensor   # [K, Kp, 8] int32
    kp_valid: Tensor  # [K, Kp] bool
    # level-0 depth gradient for the geometric factor (keyframe.h dpt_grad)
    dpt_grad: Tensor  # [K, H, W, 2]


def create(K: int, CS: int, H: int, W: int, num_levels: int, max_links: int,
           max_keypoints: int = 0, device="cuda") -> MapState:
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                    device=device)
    levels = []
    for l in range(num_levels):
        h, w = H >> l, W >> l
        levels.append(LevelData(
            img=z(K, h, w), grad=z(K, h, w, 2), prx0=z(K, h, w),
            jac=z(K, CS, h, w), stdev=z(K, h, w),
            dpt=torch.ones((K, h, w), dtype=torch.float32, device=device),
            vld=z(K, h, w)))
    return MapState(
        active=z(K, dtype=torch.bool),
        ids=torch.full((K,), -1, dtype=torch.int32, device=device),
        pose=se3m.identity((K,), device=device),
        code=z(K, CS),
        levels=tuple(levels),
        link_src=z(max_links, dtype=torch.int32),
        link_dst=z(max_links, dtype=torch.int32),
        link_active=z(max_links, dtype=torch.bool),
        next_id=z(dtype=torch.int32),
        kp_xy=z(K, max_keypoints, 2),
        kp_desc=z(K, max_keypoints, 8, dtype=torch.int32),
        kp_valid=z(K, max_keypoints, dtype=torch.bool),
        dpt_grad=z(K, H, W, 2),
    )


def add_keyframe(state: MapState, slot: int, pose: SE3, code: Tensor,
                 img_pyr: Sequence[Tensor], grad_pyr: Sequence[Tensor],
                 prx0_pyr: Sequence[Tensor], jacT_pyr: Sequence[Tensor],
                 stdev_pyr: Sequence[Tensor], avg_dpt: float,
                 features=None) -> MapState:
    """Write a decoded keyframe into ``slot`` in place (Mapper::BuildKeyframe,
    mapper.cpp:919-1007); depth is materialised immediately. ``jacT_pyr``
    is feature-major [CS, h, w] per level; ``features`` (a
    ``features.detector.Features``) fills the keypoint pools. The level-0
    depth's Sobel gradient goes to ``dpt_grad``."""
    for l, lvl in enumerate(state.levels):
        jac_hwc = jacT_pyr[l].permute(1, 2, 0)
        dpt = ip.update_depth(code, prx0_pyr[l], jac_hwc, avg_dpt)
        if l == 0:
            state.dpt_grad[slot] = ip.sobel_gradients(dpt)
        lvl.img[slot] = img_pyr[l]
        lvl.grad[slot] = grad_pyr[l]
        lvl.prx0[slot] = prx0_pyr[l]
        lvl.jac[slot] = jacT_pyr[l]
        lvl.stdev[slot] = stdev_pyr[l]
        lvl.dpt[slot] = dpt
        lvl.vld[slot] = 1.0
    if features is not None:
        state.kp_xy[slot] = features.xy
        state.kp_desc[slot] = features.descriptor
        state.kp_valid[slot] = features.valid
    state.active[slot] = True
    state.ids[slot] = state.next_id
    state.pose.q[slot] = pose.q
    state.pose.t[slot] = pose.t
    state.code[slot] = code
    state.next_id.add_(1)
    return state


def update_depth_all(state: MapState, avg_dpt: float) -> MapState:
    """Re-materialise the depth pyramids of all keyframes from the current
    codes, in place (UpdateMap writeback, mapper.cpp:859-899). The clamp
    keeps depth finite on empty slots (prx0 = 0)."""
    for lvl in state.levels:
        prx = lvl.prx0 + torch.einsum("kchw,kc->khw", lvl.jac, state.code)
        lvl.dpt.copy_(wp.prox_to_depth(torch.clamp(prx, min=1e-4), avg_dpt))
    return state


def add_link(state: MapState, link_idx: int, src: int, dst: int) -> MapState:
    state.link_src[link_idx] = src
    state.link_dst[link_idx] = dst
    state.link_active[link_idx] = True
    return state


def remove_link(state: MapState, link_idx: int) -> MapState:
    state.link_active[link_idx] = False
    return state


def poses_of(state: MapState, slots: Tensor) -> SE3:
    return SE3(state.pose.q[slots], state.pose.t[slots])
