"""The per-frame step: image pyramid, tracking and the decision probe.

PyTorch port of ``deepfactors_tpu/frame_step.py``. Per frame
(ProcessFrame, deepfactors.cpp:220-366):

    pyramid build + Sobel           (UploadLiveFrame, deepfactors.cpp:616-630)
    keyframe-pool gather            (the active keyframe's pyramid, by index)
    coarse-to-fine SE(3) tracking   (CameraTracker::TrackFrame,
                                     camera_tracker.cpp:42-91)
    feature detect + BoW vector     (with loop closure: BRISK detect + DBoW2
                                     transform, deepfactors.cpp:634-680)
    every per-frame decision scalar (CheckTrackingLost :852,
                                     NewKeyframeRequired :747,
                                     NewFrameRequired :784, SelectKeyframe
                                     :813, loop similarities,
                                     loop_detector.cpp:96-224)

The host reads back ONE packed probe vector (pose + distances + BoW
similarities + stats, the layout of ``probe_layout``, identical to the JAX
package's) and makes every control-flow decision from it; pyramids,
features and the BoW vector stay on the device for the keyframe and loop
events that use them.

Tracking state: the camera world pose is the only persistent state. Each
frame recomputes pose_ck = pose_wc^-1 * pose_wk from the current keyframe
pool pose, so mapping updates to the keyframe are picked up automatically
and keyframe switches preserve the world pose (camera_tracker.cpp:105-120).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .features import detector as det
from .geometry import se3 as se3m
from .geometry.camera import PinholeCamera, camera_pyramid
from .geometry.se3 import SE3
from .loop import vocabulary as vb
from .ops import image as ip
from .tracking.tracker import TrackerConfig, track_c2f

Tensor = torch.Tensor


class FrameStepOut(NamedTuple):
    probe: Tensor     # packed decision vector (see probe_layout)
    feat: object      # features.detector.Features, or None without loops
    bow_v: Tensor     # [V] BoW vector (None without loops)
    img_pyr: tuple    # per-level [h, w] device tensors
    grad_pyr: tuple   # per-level [h, w, 2] device tensors
    wc_q: Tensor      # [4] tracked world pose
    wc_t: Tensor      # [3]


def probe_layout(K: int, F: int, S: int = None):
    """Slice offsets of the packed probe vector:
    [wc_q(4) | wc_t(3) | d_full(K) | d_trans(K) | fr_trans(F) | sims(S) |
     rot | inliers | error].

    ``S`` is the BoW-similarity length: K + archive_cap when the loop
    detector keeps an archive of evicted keyframes, else K."""
    if S is None:
        S = K
    off = {}
    o = 0
    for name, n in (("wc_q", 4), ("wc_t", 3), ("d_full", K), ("d_trans", K),
                    ("fr_trans", F), ("sims", S), ("tail", 3)):
        off[name] = (o, o + n)
        o += n
    return off, o


def to_device(a, device) -> Tensor:
    """A host array on ``device`` without synchronising the stream.

    A copy from pageable host memory blocks until the stream has drained;
    on a CUDA device the array is staged in pinned memory and copied behind
    the stream's queue (``non_blocking``). PyTorch's caching host allocator
    records the copy's event on the pinned block and reuses the block only
    once that event has completed, so the staging buffer may be dropped at
    once. On the CPU the plain copy stays."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_frame(img, device) -> Tensor:
    """Host image (float32, float16 or uint8 [H, W]) -> float32 device
    tensor, widened on the device (``to_device``: no stream sync)."""
    t = to_device(img, device)
    if t.dtype == torch.uint8:
        return t.to(torch.float32) * (1.0 / 255.0)
    return t.to(torch.float32)


def build_frame_fn(tracker_cfg: TrackerConfig, cam: PinholeCamera,
                   levels: int, with_loop: bool, det_cfg=None):
    """Build the per-frame function.

    Call signature:
      frame_fn(img, kf_imgs, kf_dpts, kf_q, kf_t, fr_q, fr_t, curr_kf,
               prev_q, prev_t, prev2_q, prev2_t, voc=None, db=None,
               db_valid=None)
    where kf_imgs/kf_dpts are the map's per-level [K, h, w] pools, curr_kf
    is the active keyframe slot (int) and (prev2_q, prev2_t) is the pose one
    frame before prev (constant-velocity prediction; pass prev for a
    zero-velocity start). With ``with_loop`` the frame's keypoints are
    detected over its pyramid (``det_cfg``), and its BoW vector against
    ``voc`` is scored against the loop database ``db`` [S, V] /
    ``db_valid`` [S]; without it the probe's similarities are -inf."""
    cams = camera_pyramid(cam, levels)

    def frame_fn(img, kf_imgs, kf_dpts, kf_q, kf_t, fr_q, fr_t, curr_kf,
                 prev_q, prev_t, prev2_q, prev2_t, voc=None, db=None,
                 db_valid=None):
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
        if with_loop:
            feat = det.detect_pyramid(img_pyr, det_cfg)
            bow_v = vb.bow_vector(voc, feat.descriptor, feat.valid)
            sims = vb.similarity(bow_v, db, db_valid)
        else:
            feat = bow_v = None
            sims = torch.full((kf_q.shape[0],), float("-inf"),
                              device=kf_q.device)
        probe = torch.cat([pose_wc.q, pose_wc.t, d_full, d_trans, fr_trans,
                           sims, torch.stack([rot, stats[0], stats[1]])])
        return FrameStepOut(probe, feat, bow_v, img_pyr, grad_pyr, pose_wc.q,
                            pose_wc.t)

    return frame_fn
