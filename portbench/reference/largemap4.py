"""Plain reference of the large map sharded over several cards: the
equations of ``reference/largemap.py`` (the decoder, the photometric
factor, the priors, the damped Gauss-Newton step with the code blocks
eliminated by Schur complement), whose pieces it takes, at a size one card
cannot hold with its working set.

The factors are split into one block a device (``spread``), each device
holding a copy of the keyframes' planes. One process linearises every
block on its own device, chunk by chunk, the devices in turn so that they
work side by side; each chunk's normal equations (float32 on its device,
as the configuration states) are copied to the home device, the first,
and summed there into the system in the chosen precision. No collective
runs. The damping is added to the system in place, so that the float64
system (12.1 GB at K = 1,024) needs no copy of its size.

``precision`` as in ``reference/largemap.py``: ``"float64"`` (the
reference), ``"float32"`` (the configuration's own precision: the
yardstick of how far float32 alone moves a solve) or ``"tf32"`` (the
control). Imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import largemap as lm
from .largemap import Inputs, decode, gaps  # noqa: F401

Tensor = torch.Tensor
# factors linearised at once on a device: at K = 1,024 the host's launches
# pace chunks of 32 (1.9 s of host time a system), chunks of 128 do not
CHUNK = 128


class Spread(NamedTuple):
    parts: tuple     # an Inputs a device: the keyframes and its factors
    home: torch.device


def spread(inp: Inputs, devices) -> Spread:
    """The keyframes' planes on every device; the factors in contiguous
    blocks, one a device."""
    devices = [torch.device(d) for d in devices]
    P = inp.src.shape[0]
    per = -(-P // len(devices))
    parts = []
    for i, d in enumerate(devices):
        blk = slice(i * per, min(P, (i + 1) * per))
        parts.append(Inputs(inp.images.to(d), inp.grads.to(d),
                            inp.prx0.to(d), inp.jac.to(d),
                            inp.src[blk].to(d), inp.dst[blk].to(d)))
    return Spread(tuple(parts), devices[0])


def normal_equations(sp: Spread, q, t, codes, cam, sfm, priors,
                     precision="float64"):
    """The whole system at (q, t, codes), priors included, on the home
    device: (H [D, D], b [D], cost), summed in ``precision``; the layout of
    ``reference/largemap.py``."""
    K, CS = codes.shape
    D = K * (6 + CS)
    home = sp.home
    dt = lm._dtype(precision)
    H = torch.zeros((D, D), dtype=dt, device=home)
    b = torch.zeros((D,), dtype=dt, device=home)
    cost = torch.zeros((), dtype=dt, device=home)
    at = [tuple(x.to(p.images.device) for x in (q, t, codes))
          for p in sp.parts]
    ar = torch.arange(6, device=home)
    arc = torch.arange(CS, device=home)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        n = max(p.src.shape[0] for p in sp.parts)
        for a in range(0, n, CHUNK):
            for p, x in zip(sp.parts, at):
                if a >= p.src.shape[0]:
                    continue
                f = slice(a, min(p.src.shape[0], a + CHUNK))
                JtJ, Jtr, c = (y.to(home) for y in lm.linearise(
                    p, *x, cam, sfm, f))
                s, d = p.src[f].to(home), p.dst[f].to(home)
                idx = torch.cat([6 * s[:, None] + ar, 6 * d[:, None] + ar,
                                 6 * K + CS * s[:, None] + arc], 1)
                H.index_put_((idx[:, :, None].expand_as(JtJ).reshape(-1),
                              idx[:, None, :].expand_as(JtJ).reshape(-1)),
                             JtJ.to(dt).reshape(-1), accumulate=True)
                b.index_add_(0, idx.reshape(-1), Jtr.to(dt).reshape(-1))
                cost += c.to(dt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    # priors: zero codes, keyframe 0 at the origin
    q, t, codes = (x.to(home) for x in (q, t, codes))
    wc = 1.0 / priors["code_prior"] ** 2
    ci = torch.arange(6 * K, D, device=home)
    H[ci, ci] += wc
    b[ci] += wc * codes.to(dt).reshape(-1)
    wp = 1.0 / priors["pose_prior"] ** 2
    pi = torch.arange(6, device=home)
    r0 = torch.cat([t[0], lm.log_quat(q[0])]).to(dt)
    H[pi, pi] += wp
    b[:6] += wp * r0
    cost += wc * codes.to(dt).square().sum() + wp * r0.square().sum()
    return H, b, cost


def schur_solve_damped(A: Tensor, b: Tensor, K: int, CS: int, lam: float):
    """``reference/largemap.schur_solve`` with the damping lam diag(H) +
    1e-8 added to ``A``'s diagonal in place (A is H on entry)."""
    d = A.diagonal()
    d.add_(lam * d + 1e-8)
    Dp = 6 * K
    Axx, Axc = A[:Dp, :Dp], A[:Dp, Dp:].reshape(Dp, K, CS)
    k = torch.arange(K, device=A.device)
    C = A[Dp:, Dp:].reshape(K, CS, K, CS)[k, :, k, :]
    U = torch.cat([Axc.permute(1, 2, 0), b[Dp:].reshape(K, CS, 1)], -1)
    X = torch.cholesky_solve(U, lm._cholesky(C))        # C^-1 [A_cx | b_c]
    S = Axx - torch.einsum("pkc,kcq->pq", Axc, X[..., :Dp])
    rhs = b[:Dp] - torch.einsum("pkc,kc->p", Axc, X[..., Dp])
    dx = -torch.cholesky_solve(rhs[:, None], lm._cholesky(S))[:, 0]
    dc = -(X[..., Dp] + torch.einsum("kcp,p->kc", X[..., :Dp], dx))
    return torch.cat([dx, dc.reshape(-1)])


def gn_step(sp: Spread, q, t, codes, cam, sfm, priors, precision="float64"):
    """One damped Gauss-Newton step over every factor: (q, t, codes) on the
    home device."""
    K, CS = codes.shape
    H, b, _ = normal_equations(sp, q, t, codes, cam, sfm, priors, precision)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        dx = schur_solve_damped(H, b, K, CS, priors["lam"]).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del H
    q, t, codes = (x.to(sp.home) for x in (q, t, codes))
    qn, tn = lm.retract(q, t, dx[:6 * K].reshape(K, 6))
    return qn, tn, codes + dx[6 * K:].reshape(K, CS)


def solve(sp: Spread, q0: Tensor, t0: Tensor, cam, sfm: dict, priors: dict,
          iters: int, precision: str = "float64"):
    """``iters`` steps from (q0, t0) and zero codes: (q, t, codes)."""
    K, CS = sp.parts[0].jac.shape[0], sp.parts[0].jac.shape[-1]
    q, t = q0.to(sp.home), t0.to(sp.home)
    codes = torch.zeros((K, CS), device=sp.home)
    with torch.no_grad():
        for _ in range(iters):
            q, t, codes = gn_step(sp, q, t, codes, cam, sfm, priors,
                                  precision)
    return q, t, codes
