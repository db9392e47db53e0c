"""schur_crossover: dense Cholesky against the Schur-complement solve over
the window size.

PyTorch port of the JAX package's ``tools/schur_crossover.py``: global
systems with photometric-BA sparsity for K-keyframe windows (a chain plus
two back-connections, 44-dim factors, layout [poses 6K | codes CS·K | one
frame pose]), solved by ``solver/system.solve_damped`` and by
``solve_schur_codes``, for K = 4 ... 48 (D up to 1,830): the relative
difference of the two solutions, each solve's time and the crossover.

Each solve is timed by ``common.time_stage`` over N calls in a chain (each
call's right-hand side is the last solution, normalised), as the JAX tool's
scan carries it: host ms, CUDA-event µs and the profiler's kernel µs per
call. As in the JAX tool, H is perturbed by 1e-6·b[0]² on the diagonal
every call, so that every call factors a fresh matrix (eager PyTorch hoists
nothing, but the chain stays the JAX tool's). The winner is read on the
host clock and on the device (CUDA events) apart. The mapper's rule (the
Schur solve when D > 150, ``mapping/mapper.py``) is the JAX package's and
stays as it is: the crossover is recorded, not applied.

Usage: python -m deepfactors_tpu_torch.tools.schur_crossover [K ...]
       [--n 30] [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import parse_args
from ..solver import system as sysm
from .common import device_from_flag, time_stage

CS = 32
LAM = 1e-3
KS = (4, 5, 8, 12, 16, 24, 32, 48)


def build_system(K, seed=0, device="cpu") -> sysm.GlobalSystem:
    """Assemble a PSD global system with photometric-BA sparsity (the JAX
    tool's draws)."""
    rng = np.random.RandomState(seed)
    pairs = [(i, i + 1) for i in range(K - 1)]
    pairs += [(i, i + 2) for i in range(K - 2)]
    D = 6 * K + CS * K + 6  # one tracked frame pose, like the bench mapper
    Df = 12 + CS
    P = len(pairs)
    G = rng.randn(P, Df, Df + 16).astype(np.float32)
    Hf = np.einsum("pij,pkj->pik", G, G) / Df
    bf = rng.randn(P, Df).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    i0 = t(np.array([p[0] for p in pairs], np.int64))
    i1 = t(np.array([p[1] for p in pairs], np.int64))
    idx = sysm.factor_slot_indices(i0, i1, K, CS)
    gsys = sysm.assemble(D, t(Hf), t(bf), idx,
                         torch.ones((P,), dtype=torch.bool, device=device))
    # weak prior so the frame-pose slot (untouched by factors) is well-posed
    H = gsys.H + 1e-2 * torch.eye(D, device=device)
    return sysm.GlobalSystem(H, gsys.b)


def timed_per_solve(solve, gsys, dev, n=30):
    """``common.time_stage`` of ``solve`` over a chain of n calls."""
    D = gsys.H.shape[0]
    eye = torch.eye(D, device=gsys.H.device)
    carry = {"b": gsys.b / (torch.linalg.norm(gsys.b) + 1e-6)}

    def step():
        b = carry["b"]
        # H depends on the carried b: a fresh factorisation every call
        d = solve(gsys._replace(H=gsys.H + 1e-6 * b[0] * b[0] * eye, b=b))
        carry["b"] = d / (torch.linalg.norm(d) + 1e-6)
        return carry["b"]

    return time_stage(step, dev, n=n)


def main(argv, log=print) -> list:
    """Solve and time for every K; returns [{K, D, dense, schur (StageTime
    dicts), rel_err, winner_host, winner_device}]."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    n = int(flags.get("n", 30))
    ks = [int(a) for a in flags["__positional__"]] or list(KS)
    dense = lambda s: sysm.solve_damped(s, LAM)  # noqa: E731
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"dense Cholesky against solve_schur_codes on {name}; per solve: "
        f"host clock, CUDA events, profiler kernels")
    rows = []
    for K in ks:
        gsys = build_system(K, device=dev)
        schur = lambda s, K=K: sysm.solve_schur_codes(s, K, CS, LAM)  # noqa
        d_dense, d_schur = dense(gsys), schur(gsys)
        rel = float(torch.linalg.norm(d_dense - d_schur)
                    / (torch.linalg.norm(d_dense) + 1e-12))
        t_dense = timed_per_solve(dense, gsys, dev, n)
        t_schur = timed_per_solve(schur, gsys, dev, n)
        D = gsys.H.shape[0]
        win = lambda a, b: "schur" if b < a else "dense"  # noqa: E731
        row = dict(K=K, D=D, dense=t_dense._asdict(), schur=t_schur._asdict(),
                   rel_err=rel,
                   winner_host=win(t_dense.host_ms, t_schur.host_ms),
                   winner_device=(win(t_dense.event_us, t_schur.event_us)
                                  if t_dense.event_us is not None else None))
        rows.append(row)
        log(f"K={K:>3} D={D:>5} rel err {rel:9.2e}  winner host "
            f"{row['winner_host']}, device {row['winner_device']}\n"
            f"    dense {t_dense}\n    schur {t_schur}")
    for key in ("winner_host", "winner_device")[:1 + (dev.type == "cuda")]:
        cross = next((r["D"] for r in rows if r[key] == "schur"), None)
        log(f"crossover ({key[7:]}): " + (f"schur first wins at D={cross}"
                                         if cross else
                                         "dense wins at every tested size"))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
