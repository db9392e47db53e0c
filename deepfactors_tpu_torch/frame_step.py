"""The per-frame step: image pyramid, tracking and the decision probe.

PyTorch port of ``deepfactors_tpu/frame_step.py`` on its ``with_loop=False``
path (features and BoW belong to the loop-closure slice). Per frame
(ProcessFrame, deepfactors.cpp:220-366):

    pyramid build + Sobel           (UploadLiveFrame, deepfactors.cpp:616-630)
    keyframe-pool gather            (the active keyframe's pyramid, by index)
    coarse-to-fine SE(3) tracking   (CameraTracker::TrackFrame,
                                     camera_tracker.cpp:42-91)
    every per-frame decision scalar (CheckTrackingLost :852,
                                     NewKeyframeRequired :747,
                                     NewFrameRequired :784, SelectKeyframe :813)

The host reads back ONE packed probe vector (pose + distances + stats, the
layout of ``probe_layout``, identical to the JAX package's) and makes every
control-flow decision from it; pyramids stay on the device.

Tracking state: the camera world pose is the only persistent state. Each
frame recomputes pose_ck = pose_wc^-1 * pose_wk from the current keyframe
pool pose, so mapping updates to the keyframe are picked up automatically
and keyframe switches preserve the world pose (camera_tracker.cpp:105-120).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .geometry import se3 as se3m
from .geometry.camera import PinholeCamera, camera_pyramid
from .geometry.se3 import SE3
from .ops import image as ip
from .tracking.tracker import TrackerConfig, track_c2f

Tensor = torch.Tensor


class FrameStepOut(NamedTuple):
    probe: Tensor     # packed decision vector (see probe_layout)
    img_pyr: tuple    # per-level [h, w] device tensors
    grad_pyr: tuple   # per-level [h, w, 2] device tensors
    wc_q: Tensor      # [4] tracked world pose
    wc_t: Tensor      # [3]


def probe_layout(K: int, F: int, S: int = None):
    """Slice offsets of the packed probe vector:
    [wc_q(4) | wc_t(3) | d_full(K) | d_trans(K) | fr_trans(F) | sims(S) |
     rot | inliers | error]."""
    if S is None:
        S = K
    off = {}
    o = 0
    for name, n in (("wc_q", 4), ("wc_t", 3), ("d_full", K), ("d_trans", K),
                    ("fr_trans", F), ("sims", S), ("tail", 3)):
        off[name] = (o, o + n)
        o += n
    return off, o


def upload_frame(img, device) -> Tensor:
    """Host image (float or uint8 [H, W]) -> float32 device tensor."""
    t = torch.as_tensor(np.ascontiguousarray(img)).to(device)
    if t.dtype == torch.uint8:
        return t.to(torch.float32) * (1.0 / 255.0)
    return t.to(torch.float32)


def build_frame_fn(tracker_cfg: TrackerConfig, cam: PinholeCamera,
                   levels: int, with_loop: bool):
    """Build the per-frame function.

    Call signature:
      frame_fn(img, kf_imgs, kf_dpts, kf_q, kf_t, fr_q, fr_t, curr_kf,
               prev_q, prev_t, prev2_q, prev2_t)
    where kf_imgs/kf_dpts are the map's per-level [K, h, w] pools, curr_kf
    is the active keyframe slot (int) and (prev2_q, prev2_t) is the pose one
    frame before prev (constant-velocity prediction; pass prev for a
    zero-velocity start)."""
    if with_loop:
        raise NotImplementedError(
            "the frame step's loop-closure features (BRISK-like detector + "
            "BoW) come with the loop-closure slice of the port")
    cams = camera_pyramid(cam, levels)

    def frame_fn(img, kf_imgs, kf_dpts, kf_q, kf_t, fr_q, fr_t, curr_kf,
                 prev_q, prev_t, prev2_q, prev2_t):
        img = upload_frame(img, kf_q.device)
        img_pyr = tuple(ip.build_pyramid(img, levels))
        grad_pyr = tuple(ip.build_gradient_pyramid(img_pyr))
        kf_img = tuple(p[curr_kf] for p in kf_imgs)
        kf_dpt = tuple(p[curr_kf] for p in kf_dpts)
        pose_wk = SE3(kf_q[curr_kf], kf_t[curr_kf])

        # constant-velocity prediction pred = prev ∘ (prev2⁻¹ ∘ prev)
        prev = SE3(prev_q, prev_t)
        vel = se3m.mul(se3m.inverse(SE3(prev2_q, prev2_t)), prev)
        pred = se3m.mul(prev, vel)

        pose_ck0 = se3m.mul(se3m.inverse(pred), pose_wk)
        q, t, stats = track_c2f(tracker_cfg, cams, pose_ck0, kf_img, kf_dpt,
                                img_pyr, grad_pyr)
        pose_wc = se3m.mul(pose_wk, se3m.inverse(SE3(q, t)))

        kf_poses = SE3(kf_q, kf_t)
        d_full = se3m.pose_distance(kf_poses, pose_wc)
        d_trans = se3m.pose_distance(kf_poses, pose_wc, 1.0, 0.0)
        fr_trans = se3m.pose_distance(SE3(fr_q, fr_t), pose_wc, 1.0, 0.0)
        rel_q = se3m.quat_mul(kf_q[curr_kf], se3m.quat_conj(pose_wc.q))
        rot = torch.linalg.norm(se3m.so3_log(rel_q))
        # no loop detector in this slice: the BoW similarities stay -inf
        sims = torch.full((kf_q.shape[0],), float("-inf"), device=kf_q.device)
        probe = torch.cat([pose_wc.q, pose_wc.t, d_full, d_trans, fr_trans,
                           sims, torch.stack([rot, stats[0], stats[1]])])
        return FrameStepOut(probe, img_pyr, grad_pyr, pose_wc.q, pose_wc.t)

    return frame_fn
