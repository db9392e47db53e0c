"""Multi-sequence batched odometry: track S independent scenes in lockstep.

PyTorch port of ``deepfactors_tpu/parallel/multi_seq.py``. The per-scene
step (dense coarse-to-fine SE(3) tracking against the scene's keyframe, with
a keyframe switch where the camera moved too far) is batched over the scene
axis: every Gauss-Newton iteration is ONE ``se3_gram_batch`` call over
P = S scenes with sampled Sobel gradients, one batched 6x6 solve and one
batched retract; there is no Python loop over scenes. Scenes never
communicate, so several cards each run their own ``BatchedOdometry`` over
their own scenes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera, camera_pyramid
from ..geometry.se3 import SE3
from ..ops import dense_sfm as ds
from ..ops import image as ip
from ..ops.kernels import sfm_gram as sg

Tensor = torch.Tensor


class SceneState(NamedTuple):
    """Per-scene odometry state, leading axis = scenes [S, ...]."""

    kf_img: tuple      # per level [S, H_l, W_l]
    kf_dpt: tuple      # per level [S, H_l, W_l]
    kf_pose_q: Tensor  # [S, 4] pose_wk
    kf_pose_t: Tensor  # [S, 3]
    pose_ck_q: Tensor  # [S, 4] tracker state
    pose_ck_t: Tensor  # [S, 3]


class BatchedOdometry:
    """Lockstep odometry over S scenes."""

    def __init__(self, cam: PinholeCamera, levels: int,
                 iters_per_level=(8, 6), huber: float = 0.3,
                 kf_dist_threshold: float = 0.15):
        self.levels = levels
        self.iters_per_level = iters_per_level
        self.huber = huber
        self.kf_dist_threshold = kf_dist_threshold
        self.cams = camera_pyramid(cam, levels)

    def init(self, imgs: Tensor, depths: Tensor) -> SceneState:
        """imgs/depths: [S, H, W] first frames of each scene, on the device
        the odometry is to run on."""
        kf_dpt = [depths]
        for _ in range(self.levels - 1):
            kf_dpt.append(kf_dpt[-1][:, ::2, ::2].contiguous())
        ident = se3m.identity((imgs.shape[0],), device=imgs.device)
        return SceneState(
            kf_img=tuple(ip.build_pyramid(imgs, self.levels)),
            kf_dpt=tuple(kf_dpt), kf_pose_q=ident.q, kf_pose_t=ident.t,
            pose_ck_q=ident.q, pose_ck_t=ident.t)

    def _track(self, state: SceneState, pyr, grads) -> SE3:
        S = pyr[0].shape[0]
        slot = torch.arange(S, dtype=torch.int32, device=pyr[0].device)
        pose = SE3(state.pose_ck_q, state.pose_ck_t)
        for level in reversed(range(self.levels)):
            gx = grads[level][..., 0].contiguous()
            gy = grads[level][..., 1].contiguous()
            for _ in range(self.iters_per_level[level]):
                kp = sg.make_sfm_params(pose, self.cams[level], 1, 0.0,
                                        self.huber, 2.0)
                G = sg.se3_gram_batch(
                    kp, slot, slot, state.kf_img[level], state.kf_dpt[level],
                    pyr[level], gx, gy, grad_mode="sampled")
                JtJ = 0.5 * (G[:, :6, :6] + G[:, :6, :6].transpose(1, 2))
                pose = ds.se3_solve_and_update(JtJ, G[:, :6, 6], pose,
                                               damping=1e-8)
        return pose

    def process(self, state: SceneState, imgs: Tensor):
        """One lockstep frame for all scenes (imgs [S, H, W]): the new
        state, the tracked world poses pose_wc [S] and which scenes switched
        their keyframe [S] bool."""
        pyr = ip.build_pyramid(imgs, self.levels)
        grads = ip.build_gradient_pyramid(pyr)
        pose_ck = self._track(state, pyr, grads)
        # keyframe switch where the camera moved too far: the live frame
        # becomes the new keyframe at the tracked world pose
        switch = torch.linalg.norm(pose_ck.t, dim=-1) > self.kf_dist_threshold
        pose_wc = se3m.mul(SE3(state.kf_pose_q, state.kf_pose_t),
                           se3m.inverse(pose_ck))

        def sel(new, old):
            return torch.where(
                switch.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        ident = se3m.identity(switch.shape, device=imgs.device)
        new_state = SceneState(
            kf_img=tuple(sel(p, k) for p, k in zip(pyr, state.kf_img)),
            kf_dpt=state.kf_dpt,  # constant-depth prior until decode
            kf_pose_q=sel(pose_wc.q, state.kf_pose_q),
            kf_pose_t=sel(pose_wc.t, state.kf_pose_t),
            pose_ck_q=sel(ident.q, pose_ck.q),
            pose_ck_t=sel(ident.t, pose_ck.t))
        return new_state, pose_wc, switch
