"""Large-map bundle adjustment over a link table.

PyTorch port of ``deepfactors_tpu/parallel/large_map.py``: build the
per-factor data of ``dist_ba`` from a map and a list of keyframe links, and
drive the BA step to convergence. With a ``torch.distributed`` process
group each rank builds and linearises its own shard of the factors and the
[D, D] system is summed over the group; with none it is one process on one
card.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..ops import dense_sfm as ds
from . import dist_ba

Tensor = torch.Tensor


class LargeMapProblem(NamedTuple):
    pose_q: Tensor   # [K, 4]
    pose_t: Tensor   # [K, 3]
    codes: Tensor    # [K, CS]
    active: Tensor   # [K] bool
    fd: dist_ba.ShardedFactorData


def build_problem(images: Tensor, prx0: Tensor, jac: Tensor, stdev: Tensor,
                  grads: Tensor, poses: SE3, codes: Tensor, links: Sequence,
                  world_size: int = 1, rank: int = 0) -> LargeMapProblem:
    """Gather per-factor data for all link pairs, both directions (images,
    prx0, stdev [K, H, W], jac [K, H, W, CS], grads [K, H, W, 2]; links a
    list of (i, j) keyframe index pairs), and keep the shard of ``rank``.
    The tensors stay on the device of ``images``."""
    pairs = [p for i, j in links for p in ((i, j), (j, i))]
    dev = images.device
    # the factor table padded to equal shards with inactive rows; only this
    # rank's rows are gathered, so the full factor set need not fit
    per = -(-len(pairs) // world_size)
    table = np.zeros((per * world_size, 3), np.int64)
    table[:len(pairs), :2] = pairs
    table[:len(pairs), 2] = 1
    s, d, act = torch.as_tensor(table[rank * per:(rank + 1) * per],
                                device=dev).unbind(1)
    fd = dist_ba.ShardedFactorData(
        src=s, dst=d, active=act.bool(), img0=images[s], img1=images[d],
        prx0=prx0[s], jac0=jac[s], std0=stdev[s], grad1=grads[d])
    K = images.shape[0]
    return LargeMapProblem(pose_q=poses.q, pose_t=poses.t, codes=codes,
                           active=torch.ones(K, dtype=torch.bool, device=dev),
                           fd=fd)


class LargeMapBA:
    """Iterates the Schur GN step of ``dist_ba.make_ba_step`` over a problem."""

    def __init__(self, K: int, CS: int, cam: PinholeCamera,
                 params: ds.SfmParams, code_prior: float = 1.0,
                 pose_prior: float = 0.3, lam: float = 1e-4, group=None):
        self.step = dist_ba.make_ba_step(K, CS, cam, params, code_prior,
                                         pose_prior, lam, group)

    def run(self, problem: LargeMapProblem, iters: int = 10):
        """``iters`` steps from the problem's estimate: (poses, codes, the
        (residual, inliers) statistics of every step)."""
        q, t, c = problem.pose_q, problem.pose_t, problem.codes
        stats_hist = []
        for _ in range(iters):
            q, t, c, stats = self.step(q, t, c, problem.fd, problem.active)
            stats_hist.append(stats)
        return SE3(q, t), c, stats_hist
