"""profile_ba: the stages of one BA (mapping GN) iteration at the bench
problem size, host time against device time.

PyTorch port of the JAX package's ``tools/profile_ba.py``, on the mapper
of ``profile_dispatch._bench_mapper`` (K = 5, CS 32, 192x256, 3 levels,
``use_schur``, LASTN/2, every work at level 0, D = 196). The JAX tool
times each stage by loop-length differencing inside one ``jit``; eager
PyTorch has none, so each stage is timed by ``common.time_stage``: host ms
over N back-to-back calls ending in a synchronise, CUDA-event µs over the
same calls, and the sum of the profiler's kernel durations in one call
with their count (the device's own work: CUDA events read host time once
the launch queue of a many-launch stage fills). Stages, each the port's
counterpart of the JAX one:
  - ``map_state.update_depth_all`` (all levels);
  - ``factors.photometric_batch`` at level 0 as ``Mapper.gn_iteration``
    calls it (depth from the code, the fine loss): ``sfm_gram_batch``;
  - ``solver/system.assemble`` of that batch;
  - the priors and the mask (marginal priors, code prior, anchor prior,
    ``mask_inactive``), as ``gn_iteration`` adds them;
  - ``solve_damped`` (dense Cholesky, D = 196) and ``solve_schur_codes``,
    each on a system perturbed per call so that every call factors anew;
  - the retract of poses and codes;
  - the full iteration: ``Mapper._run`` (the JAX ``_run_fn``), per
    iteration.

Usage: python -m deepfactors_tpu_torch.tools.profile_ba [--n 20]
       [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from ..config import parse_args
from ..geometry import se3 as se3m
from ..mapping import factors as fct
from ..mapping import map_state as ms
from ..mapping import marginal as mg
from ..solver import system as sysm
from .common import device_from_flag, time_stage
from .profile_dispatch import _bench_mapper


def stages(m, pool, dev) -> list:
    """(name, fn) of every stage on the mapper ``m`` and its compacted
    ``pool``; the stages after the first linearisation use its batch."""
    cfg = m.cfg
    K, CS, F = cfg.max_keyframes, cfg.code_size, cfg.max_frames
    Dp, Dc = 6 * K, CS * K
    D = Dp + Dc + 6 * F
    state0 = m.state
    t = lambda a, dt=torch.long: torch.as_tensor(a, device=dev).to(dt)  # noqa
    src, dst, act = t(pool.src), t(pool.dst), t(pool.active, torch.bool)
    isf, level = t(pool.dst_is_frame, torch.bool), t(pool.level)
    kk = act & ~isf & (level == 0)     # keyframe factors at level 0
    lp, lloss = m._level_loss(0)

    def photo():
        return fct.photometric_batch(state0, src, dst, 0, m.cams[0], lp,
                                     active=kk, grad_mode=cfg.grad_mode,
                                     depth_from_code=True, loss=lloss)

    b0 = photo()
    idx = sysm.factor_slot_indices(src, dst, K, CS)
    gs = sysm.assemble(D, b0.JtJ, b0.Jtr, idx, kk)
    ar6 = torch.arange(6, device=dev)
    arCS = torch.arange(CS, device=dev)
    slots = torch.arange(K, device=dev)

    def priors():
        mH, mg_ = mg.prior_terms(m.marginals, state0.pose, state0.code)
        midx = torch.cat([slots[:, None] * 6 + ar6,
                          Dp + slots[:, None] * CS + arCS], dim=-1)
        mgsys = sysm.assemble(D, mH, mg_, midx, m.marginals.active)
        g = sysm.GlobalSystem(gs.H + mgsys.H, gs.b + mgsys.b)
        code_mask = state0.active.repeat_interleave(CS).to(torch.float32)
        g = sysm.add_diagonal_prior(g, Dp + torch.arange(Dc, device=dev),
                                    code_mask / cfg.code_prior ** 2,
                                    state0.code.reshape(-1))
        a = m.kf_slots[0]
        g = sysm.add_diagonal_prior(
            g, a * 6 + ar6,
            torch.full((6,), 1.0 / cfg.pose_prior ** 2, device=dev),
            se3m.local(m._anchor_pose, se3m.index(state0.pose, a)))
        fr_live = m.frames.active & ~m.frames.marginalized
        vmask = torch.cat([state0.active.repeat_interleave(6),
                           state0.active.repeat_interleave(CS),
                           fr_live.repeat_interleave(6)])
        return sysm.mask_inactive(g, vmask)

    A = gs.H + torch.eye(D, device=dev) * 10.0
    eye = torch.eye(D, device=dev)
    carry = {"b": gs.b}

    def solve(fn):
        def step():
            b = carry["b"]
            # a new matrix each call: every call factors it anew
            d = fn(sysm.GlobalSystem(A + b[0] * 1e-12 * eye, b))
            carry["b"] = b + 1e-12 * d
            return d
        return step

    delta = torch.ones((D,), device=dev)

    def retract():
        pose = se3m.retract(state0.pose, 1e-9 * delta[:Dp].reshape(K, 6))
        return pose, state0.code + 1e-9 * delta[Dp:Dp + Dc].reshape(K, CS)

    return [
        ("update_depth_all (L0-2)",
         lambda: ms.update_depth_all(state0, cfg.avg_dpt)),
        ("photometric_batch L0", photo),
        ("assemble", lambda: sysm.assemble(D, b0.JtJ, b0.Jtr, idx, kk)),
        ("priors+mask", priors),
        (f"solve_damped chol({D})",
         solve(lambda g: sysm.solve_damped(g, 1e-4))),
        ("solve_schur_codes", solve(
            lambda g: sysm.solve_schur_codes(g, K, CS, 1e-4))),
        ("retract+update", retract),
        ("full gn_iteration (_run)",
         lambda: m._run(pool, (0,), 1, bool(pool.dst_is_frame.any()))),
    ]


def main(argv, log=print) -> dict:
    """Time every stage; returns {stage: StageTime as a dict}."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    n = int(flags.get("n", 20))
    m, pool = _bench_mapper(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"P={int(pool.active.sum())} slots={len(pool.active)} on {name}; "
        f"per call: host clock, CUDA events, profiler kernels")
    out = {}
    for label, fn in stages(m, pool, dev):
        t = time_stage(fn, dev, n=n)
        log(f"{label:<26}: {t}")
        out[label] = t._asdict()
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
