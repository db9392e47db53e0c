"""TUM-format trajectory IO and ATE (own copy of
``deepfactors_tpu/utils/tum_io.py``; reference sources/common/tum_io.h).

Format per line: ``timestamp tx ty tz qx qy qz qw``. Poses may hold numpy
arrays or tensors (on any device).
"""
from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def save_trajectory(path: str, trajectory):
    """trajectory: list of (timestamp, SE3 pose_wc)."""
    with open(path, "w") as f:
        for ts, pose in trajectory:
            t, q = _np(pose.t), _np(pose.q)  # q wxyz
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def ate_rmse(est, gt, align_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after Umeyama/Horn alignment of the
    estimated trajectory to ground truth (README.md:156-160 of the
    reference)."""
    err = ate_errors(est, gt, align_scale)
    if np.isfinite(err).sum() < 3:
        return float("inf")
    return float(np.sqrt((err[np.isfinite(err)] ** 2).mean()))


def ate_errors(est, gt, align_scale: bool = False) -> np.ndarray:
    """Per-pose translation error [N] of the estimated trajectory after the
    alignment ``ate_rmse`` makes (fitted on the finite poses; NaN where a
    pose is not finite)."""
    P = np.stack([_np(p.t) for _, p in est])
    Q = np.stack([_np(p.t) for _, p in gt])
    assert P.shape == Q.shape and len(P) >= 3
    finite = np.isfinite(P).all(axis=1) & np.isfinite(Q).all(axis=1)
    out = np.full(len(P), np.nan)
    if finite.sum() < 3:
        return out
    Pf, Qf = P[finite], Q[finite]
    mp, mq = Pf.mean(0), Qf.mean(0)
    Pc, Qc = Pf - mp, Qf - mq
    W = Qc.T @ Pc / len(Pf)
    U, D, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (np.trace(np.diag(D) @ S) / ((Pc ** 2).sum() / len(Pf))
         if align_scale else 1.0)
    t = mq - s * R @ mp
    out[finite] = np.linalg.norm((s * (R @ Pf.T)).T + t - Qf, axis=1)
    return out
