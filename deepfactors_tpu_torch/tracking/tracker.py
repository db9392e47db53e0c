"""Dense SE(3) camera tracker: coarse-to-fine Gauss-Newton odometry against
the active keyframe.

PyTorch port of ``deepfactors_tpu/tracking/tracker.py`` (reference
sources/core/system/camera_tracker.{h,cpp}). Each GN iteration is one
``dense_sfm.se3_step`` (the ``se3_gram_batch`` kernel on the card) and a
6x6 Cholesky solve; nothing syncs with the host inside the C2F schedule.

Pose state: pose_ck maps keyframe (cam k) points into the current frame
(cam c). World pose: pose_wc = pose_wk * pose_ck^-1 (camera_tracker.cpp:
98-103).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import configure_numerics
from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera, camera_pyramid
from ..geometry.se3 import SE3
from ..ops import dense_sfm as ds

Tensor = torch.Tensor


class TrackerConfig(NamedTuple):
    pyramid_levels: int = 3
    iterations_per_level: tuple = (10, 5, 4)  # finest-first like reference
    huber_delta: float = 0.3
    # 'interp' = exact bilinear-interpolant gradient; 'sampled' = Sobel
    # planes sampled at the warp (lucas_kanade_se3.h:52-58)
    grad_mode: str = "interp"


class TrackResult(NamedTuple):
    pose_ck: SE3
    inliers: Tensor   # fraction of valid pixels at the finest level
    error: Tensor     # avg residual at finest level (inf if no inliers)


def track_c2f(cfg: TrackerConfig, cams, pose_ck: SE3, kf_imgs, kf_dpts,
              imgs, grads):
    """Coarse-to-fine dense SE(3) tracking (camera_tracker.cpp:42-91): a
    fixed number of GN iterations per level with the decoupled retract.
    Returns (q, t, stats [inliers, error]) as device tensors."""
    q, t = pose_ck.q, pose_ck.t
    inliers = torch.zeros((), dtype=torch.float32, device=q.device)
    error = torch.full((), float("inf"), dtype=torch.float32, device=q.device)
    for level in reversed(range(cfg.pyramid_levels)):
        img0, dpt0 = kf_imgs[level], kf_dpts[level]
        img1, grad1 = imgs[level], grads[level]
        for _ in range(cfg.iterations_per_level[level]):
            sys = ds.se3_step(SE3(q, t), cams[level], img0, img1, dpt0, grad1,
                              cfg.huber_delta, grad_mode=cfg.grad_mode)
            new_pose = ds.se3_solve_and_update(sys.JtJ, sys.Jtr, SE3(q, t),
                                               damping=1e-8)
            q, t = new_pose.q, new_pose.t
            inliers = sys.inliers / (img1.shape[0] * img1.shape[1])
            error = torch.where(
                sys.inliers > 0,
                sys.residual / torch.clamp(sys.inliers, min=1.0),
                torch.full_like(sys.residual, float("inf")))
    return q, t, torch.stack([inliers, error])


class CameraTracker:
    """Stateful facade mirroring the reference CameraTracker. Keyframe
    pyramids and poses are device tensors on ``device``."""

    def __init__(self, cfg: TrackerConfig, cam: PinholeCamera,
                 device="cuda"):
        assert len(cfg.iterations_per_level) == cfg.pyramid_levels
        configure_numerics()
        self.cfg = cfg
        self.cam = cam
        self.device = torch.device(device)
        self.cams = camera_pyramid(cam, cfg.pyramid_levels)
        self.pose_ck: SE3 = se3m.identity(device=self.device)
        self.kf_imgs = None
        self.kf_dpts = None
        self.kf_pose_wk: SE3 = se3m.identity(device=self.device)
        self.inliers = 0.0
        self.error = float("inf")
        self.stats = None

    def set_keyframe(self, kf_imgs, kf_dpts, pose_wk: SE3):
        """SetKeyframe (camera_tracker.cpp:105-120): preserve the world pose
        across the keyframe switch."""
        if self.kf_imgs is not None:
            pose_wc = se3m.mul(self.kf_pose_wk, se3m.inverse(self.pose_ck))
            self.pose_ck = se3m.mul(se3m.inverse(pose_wc), pose_wk)
        self.kf_imgs = tuple(kf_imgs)
        self.kf_dpts = tuple(kf_dpts)
        self.kf_pose_wk = pose_wk

    def set_pose(self, pose_wc: SE3):
        self.pose_ck = se3m.mul(se3m.inverse(pose_wc), self.kf_pose_wk)

    def track_frame(self, img_pyr, grad_pyr, sync_stats: bool = True) -> TrackResult:
        """One dense track. With sync_stats=False the scalar stats stay on
        the device (read ``.stats`` later)."""
        if self.kf_imgs is None:
            raise RuntimeError("TrackFrame called before a keyframe was set")
        q, t, stats = track_c2f(self.cfg, self.cams, self.pose_ck,
                                self.kf_imgs, self.kf_dpts, tuple(img_pyr),
                                tuple(grad_pyr))
        self.pose_ck = SE3(q, t)
        self.stats = stats
        if sync_stats:
            inl, err = stats.tolist()
            self.inliers = float(inl)
            self.error = float(err)
        return TrackResult(self.pose_ck, stats[0], stats[1])

    def track_burst(self, img_pyrs, grad_pyrs):
        """Track N stacked frames back to back, each from the previous
        frame's device pose, with no host read between them (the JAX
        package's ``lax.scan`` burst: one ``track_c2f`` a frame, kernel 1
        at P = 1 per GN iteration).

        img_pyrs/grad_pyrs: per-level stacked tensors [N, h, w] /
        [N, h, w, 2]. Updates pose_ck to the last frame's. Returns
        (poses_q [N, 4], poses_t [N, 3], stats [N, 2]) on the device."""
        if self.kf_imgs is None:
            raise RuntimeError("TrackBurst called before a keyframe was set")
        q, t = self.pose_ck.q, self.pose_ck.t
        qs, ts, sts = [], [], []
        for i in range(img_pyrs[0].shape[0]):
            q, t, st = track_c2f(self.cfg, self.cams, SE3(q, t),
                                 self.kf_imgs, self.kf_dpts,
                                 tuple(p[i] for p in img_pyrs),
                                 tuple(g[i] for g in grad_pyrs))
            qs.append(q)
            ts.append(t)
            sts.append(st)
        qs, ts, stats = torch.stack(qs), torch.stack(ts), torch.stack(sts)
        self.pose_ck = SE3(qs[-1], ts[-1])
        self.stats = stats[-1]
        return qs, ts, stats

    def get_pose_estimate(self) -> SE3:
        return se3m.mul(self.kf_pose_wk, se3m.inverse(self.pose_ck))

    def reset(self):
        self.pose_ck = se3m.identity(device=self.device)
