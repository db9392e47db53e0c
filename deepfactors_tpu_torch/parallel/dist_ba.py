"""Photometric bundle adjustment over factor-sharded data.

PyTorch port of ``deepfactors_tpu/parallel/dist_ba.py``. Every factor row
carries its own gathered images, proximity, code Jacobian and gradients, so
a process holds only its shard of the factors; it linearises the shard in
one unfused ``dense_sfm.sfm_step_batch`` call with sampled Sobel gradients
(per chunk of factors, one ``dense_warp_batch`` and one ``jacobian_stack``
kernel launch, then the JtJ ``bmm``), assembles the dense [D, D] system
(D = K*(6+CS)), and the solve with Schur elimination of the code blocks and
the variable update run replicated.

Where the JAX package takes a device mesh and an axis name, ``make_ba_step``
takes an optional ``torch.distributed`` process group: with none, or a
world of one, no collective is issued; with more, H, b and the statistics
are ``all_reduce``d over the group (each rank passes its own shard from
``shard_factors``), inside the span ``ba.allreduce``, and the bytes this
process all-reduces are counted (``allreduce_bytes()``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..ops import dense_sfm as ds
from ..solver import system as sysm
from ..utils.timing import span

Tensor = torch.Tensor

# bytes the BA steps of this process have all-reduced since the last reset
ALLREDUCED = {"bytes": 0}


def allreduce_bytes() -> int:
    """Bytes this process's BA steps have all-reduced since the last reset:
    its own buffers, 4 (D^2 + D + 2) a step at fp32."""
    return ALLREDUCED["bytes"]


def reset_allreduce_bytes() -> None:
    ALLREDUCED["bytes"] = 0


class ShardedFactorData(NamedTuple):
    """Per-factor gathered data, split on the leading (factor) axis."""

    src: Tensor     # [P] int keyframe index of the depth-owning keyframe
    dst: Tensor     # [P] int keyframe index of the target keyframe
    active: Tensor  # [P] bool
    img0: Tensor    # [P, H, W]
    img1: Tensor    # [P, H, W]
    prx0: Tensor    # [P, H, W]
    jac0: Tensor    # [P, H, W, CS]
    std0: Tensor    # [P, H, W]
    grad1: Tensor   # [P, H, W, 2]


def local_system(pose_q: Tensor, pose_t: Tensor, codes: Tensor,
                 fd: ShardedFactorData, K: int, CS: int, cam: PinholeCamera,
                 params: ds.SfmParams):
    """The system of one shard of factors: (H [D, D], b [D], stats [2] =
    (residual, inliers) summed over the active factors). Inactive rows
    (the padding of ``shard_factors``) are linearised and masked out."""
    with span("ba.linearise"):
        src, dst, sys = _linearise(pose_q, pose_t, codes, fd, cam, params)
    with span("ba.assemble"):
        return _assemble(sys, src, dst, fd.active, K, CS)


def _linearise(pose_q, pose_t, codes, fd: ShardedFactorData,
               cam: PinholeCamera, params: ds.SfmParams):
    """(src, dst, every factor's JtJ, Jtr and statistics at the current
    estimate)."""
    src, dst = fd.src.long(), fd.dst.long()
    code0 = codes[src]
    prx = fd.prx0 + torch.einsum("phwc,pc->phw", fd.jac0, code0)
    dpt0 = params.avg_dpt / prx - params.avg_dpt
    return src, dst, ds.sfm_step_batch(
        SE3(pose_q[src], pose_t[src]), SE3(pose_q[dst], pose_t[dst]), code0,
        cam, fd.img0, fd.img1, dpt0, fd.std0, fd.jac0, fd.grad1, params,
        grad_mode="sampled")


def _assemble(sys, src, dst, active, K: int, CS: int):
    """The factors' blocks summed into (H, b), and the active factors'
    (residual, inliers)."""
    idx = sysm.factor_slot_indices(src, dst, K, CS)
    gsys = sysm.assemble(6 * K + CS * K, sys.JtJ, sys.Jtr, idx, active)
    on = active.bool()
    zero = torch.zeros_like(sys.residual)
    stats = torch.stack([torch.where(on, sys.residual, zero).sum(),
                         torch.where(on, sys.inliers, zero).sum()])
    return gsys.H, gsys.b, stats


def make_ba_step(K: int, CS: int, cam: PinholeCamera, params: ds.SfmParams,
                 code_prior: float = 1.0, pose_prior: float = 0.3,
                 lam: float = 1e-4, group=None):
    """Build the BA step ``step(pose_q [K, 4], pose_t [K, 3], codes [K, CS],
    fd, active_kf [K]) -> (pose_q, pose_t, codes, stats)``: linearise this
    process's factors, sum the systems over ``group``, add the zero-code
    prior and the prior pinning keyframe 0 (df_work.cpp:29-57), solve with
    Schur elimination of the code blocks, retract. Three spans tile the
    step: ``ba.linearise``, ``ba.assemble`` (with the priors, the mask
    and, where there is a group, the ``all_reduce`` in its own nested span
    ``ba.allreduce``) and ``ba.solve`` (with the retract)."""
    reduce = (group is not None
              and torch.distributed.get_world_size(group) > 1)

    def step(pose_q, pose_t, codes, fd: ShardedFactorData, active_kf):
        dev = pose_q.device
        with span("ba.linearise"):
            src, dst, sys = _linearise(pose_q, pose_t, codes, fd, cam,
                                       params)
        with span("ba.assemble"):
            H, b, stats = _assemble(sys, src, dst, fd.active, K, CS)
            if reduce:
                with span("ba.allreduce"):
                    for x in (H, b, stats):
                        torch.distributed.all_reduce(x, group=group)
                ALLREDUCED["bytes"] += sum(x.numel() * x.element_size()
                                           for x in (H, b, stats))
            gsys = sysm.GlobalSystem(H, b)
            on = active_kf.bool()
            code_idx = 6 * K + torch.arange(CS * K, device=dev)
            gsys = sysm.add_diagonal_prior(
                gsys, code_idx,
                (1.0 / code_prior ** 2) * on.repeat_interleave(CS).to(H.dtype),
                codes.reshape(-1))
            anchor_res = se3m.local(se3m.identity(device=dev),
                                    SE3(pose_q[0], pose_t[0]))
            gsys = sysm.add_diagonal_prior(
                gsys, torch.arange(6, device=dev),
                torch.full((6,), 1.0 / pose_prior ** 2, device=dev),
                anchor_res)
            vmask = torch.cat([on.repeat_interleave(6),
                               on.repeat_interleave(CS)])
            gsys = sysm.mask_inactive(gsys, vmask)
        with span("ba.solve"):
            delta = sysm.solve_schur_codes(gsys, K, CS, lam)
            new_pose = se3m.retract(SE3(pose_q, pose_t),
                                    delta[:6 * K].reshape(K, 6))
            return (new_pose.q, new_pose.t,
                    codes + delta[6 * K:].reshape(K, CS), stats)

    return step


def shard_factors(fd: ShardedFactorData, world_size: int = 1,
                  rank: int = 0) -> ShardedFactorData:
    """The shard of ``rank`` among ``world_size`` equal shards: the factor
    count is padded to a multiple of ``world_size`` with inactive all-zero
    rows, then split in order."""
    n = fd.src.shape[0]
    pad = (-n) % world_size
    if pad:
        fd = ShardedFactorData(*(
            torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                      device=x.device)]) for x in fd))
    per = (n + pad) // world_size
    return ShardedFactorData(*(x[rank * per:(rank + 1) * per] for x in fd))


def factors_from_map_state(state, src, dst, active,
                           level: int = 0) -> ShardedFactorData:
    """The mapper-to-BA bridge: gather the per-factor rows of a (src, dst)
    photometric factor table from a ``mapping.map_state.MapState``, so a
    mapper window can be handed to ``make_ba_step`` without reshaping the
    map. The map's feature-major Jacobian [K, CS, H, W] becomes this
    module's [P, H, W, CS]."""
    lvl = state.levels[level]
    dev = lvl.img.device
    src = torch.as_tensor(src, device=dev).long()
    dst = torch.as_tensor(dst, device=dev).long()
    return ShardedFactorData(
        src=src, dst=dst,
        active=torch.as_tensor(active, device=dev).bool(),
        img0=lvl.img[src], img1=lvl.img[dst], prx0=lvl.prx0[src],
        jac0=lvl.jac[src].permute(0, 2, 3, 1).contiguous(),
        std0=lvl.stdev[src], grad1=lvl.grad[dst])
