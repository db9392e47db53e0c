"""Plain reference of the large map: decode the keyframes, then photometric
bundle adjustment of poses and codes, Gauss-Newton step by step.

Written from the equations the configuration names, not from the program:
the decoder of ``reference/net.py``; per factor (src keyframe 0, dst
keyframe 1) and pixel the residual r = I0(x) - I1(pi(T_10 p)) with
p = depth(x) [u, v, 1], depth = avg / prx - avg, prx = prx0 + J c0
(DeepFactors' photometric factor, dense_sfm.h:124-201), the image gradient
at the warped pixel taken from the Sobel planes of I1 sampled bilinearly,
Huber weights on residual and Jacobian row, pixels inside the border and in
front of the camera; the decoupled pose tangent (t += dt, R = exp(dw) R);
the zero-code prior and the prior pinning keyframe 0 (df_work.cpp:29-57);
Levenberg-Marquardt damping lam diag(H) + 1e-8; the solve with the code
blocks eliminated by Schur complement.

Each factor's normal equations are formed in float32 on the device, as the
configuration states (TF32 off). ``precision`` says how the system is
summed and solved: ``"float64"`` (the reference), ``"float32"`` (the
configuration's own precision throughout: the yardstick of how far float32
alone moves a solve from a given start) or ``"tf32"`` (float32 with TF32
matrix products throughout: the control).
Imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import net

Tensor = torch.Tensor
CHUNK = 32          # factors linearised at once


class Inputs(NamedTuple):
    images: Tensor   # [K, H, W]
    grads: Tensor    # [K, H, W, 2] Sobel planes (dx, dy)
    prx0: Tensor     # [K, H, W] proximity at the predicted code
    jac: Tensor      # [K, H, W, CS]
    src: Tensor      # [P] long
    dst: Tensor      # [P] long


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def quat_matrix(q: Tensor) -> Tensor:
    """[..., 4] wxyz unit quaternion -> [..., 3, 3]."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    r = [[w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
          2 * (x * z + w * y)],
         [2 * (x * y + w * z), w * w - x * x + y * y - z * z,
          2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x),
          w * w - x * x - y * y + z * z]]
    return torch.stack([torch.stack(row, -1) for row in r], -2)


def quat_product(a: Tensor, b: Tensor) -> Tensor:
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    w = aw * bw - (av * bv).sum(-1, keepdim=True)
    v = aw * bv + bw * av + torch.linalg.cross(av, bv, dim=-1)
    return torch.cat([w, v], -1)


def exp_quat(w: Tensor) -> Tensor:
    """Axis-angle [..., 3] -> unit quaternion (series below 1e-4 rad)."""
    th = w.norm(dim=-1, keepdim=True)
    small = th < 1e-4
    s = torch.where(small, 0.5 - th * th / 48.0,
                    torch.sin(0.5 * th) / torch.where(small, 1.0, th))
    return torch.cat([torch.cos(0.5 * th), s * w], -1)


def log_quat(q: Tensor) -> Tensor:
    """Unit quaternion -> axis-angle [..., 3], shortest rotation."""
    q = torch.where(q[..., :1] < 0, -q, q)
    vn = q[..., 1:].norm(dim=-1, keepdim=True)
    ang = 2.0 * torch.atan2(vn, q[..., :1])
    k = torch.where(vn < 1e-9, 2.0 / q[..., :1].clamp(min=0.5),
                    ang / torch.where(vn < 1e-9, 1.0, vn))
    return k * q[..., 1:]


def retract(q: Tensor, t: Tensor, d: Tensor):
    """Decoupled update: t + d[:3], exp(d[3:]) R."""
    qn = quat_product(exp_quat(d[..., 3:]), q)
    return qn / qn.norm(dim=-1, keepdim=True), t + d[..., :3]


def skew(v: Tensor) -> Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode(params: dict, images: Tensor, levels: int, batch: int = 16):
    """(prx0 with the predicted code folded in [K, H, W], code Jacobian
    [K, H, W, CS]) of the finest level."""
    prx, jac = [], []
    for a in range(0, images.shape[0], batch):
        out = net.decoder_forward(params, images[a:a + batch], levels)
        j = out["jac"][0]
        prx.append(out["prx0"][0] + (j * out["code_pred"][:, :, None, None])
                   .sum(1))
        jac.append(j.permute(0, 2, 3, 1).contiguous())
    return torch.cat(prx), torch.cat(jac)


# ---------------------------------------------------------------------------
# one Gauss-Newton step
# ---------------------------------------------------------------------------

def _sample(planes: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """planes [F, C, H, W] bilinearly at x, y [F, N] (clamped corners) ->
    [F, C, N]."""
    Fn, C, H, W = planes.shape
    x0 = torch.floor(x).clamp(0, W - 1)
    y0 = torch.floor(y).clamp(0, H - 1)
    ax = (x - x0).clamp(0, 1)
    ay = (y - y0).clamp(0, 1)
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = planes.reshape(Fn, C, H * W)
    at = lambda yy, xx: torch.gather(
        flat, 2, (yy * W + xx)[:, None, :].expand(Fn, C, -1))
    ax, ay = ax[:, None], ay[:, None]
    top = at(y0, x0) * (1 - ax) + at(y0, x1) * ax
    bot = at(y1, x0) * (1 - ax) + at(y1, x1) * ax
    return top * (1 - ay) + bot * ay


def linearise(inp: Inputs, q: Tensor, t: Tensor, codes: Tensor, cam, sfm,
              f: slice):
    """Normal equations of the factors ``f``: (JtJ [F, 12 + CS, 12 + CS],
    Jtr [F, 12 + CS], the sum of their squared weighted residuals), row
    layout [pose src | pose dst | code src]."""
    s, d = inp.src[f], inp.dst[f]
    R0, R1 = quat_matrix(q[s]), quat_matrix(q[d])
    R1T = R1.transpose(-1, -2)
    R10 = R1T @ R0
    t10 = (R1T @ (t[s] - t[d])[..., None])[..., 0]
    K, H, W, CS = inp.jac.shape
    dev = q.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    ray = torch.stack([(xs.reshape(-1) - cam.u0) / cam.fx,
                       (ys.reshape(-1) - cam.v0) / cam.fy,
                       torch.ones(H * W, device=dev)], 0)        # [3, N]
    jac = inp.jac[s].reshape(-1, H * W, CS)                       # [F, N, CS]
    prx = inp.prx0[s].reshape(-1, H * W) + (jac @ codes[s][..., None])[..., 0]
    depth = sfm["avg_dpt"] / prx - sfm["avg_dpt"]
    m = R10 @ ray                                                 # [F, 3, N]
    pc = m * depth[:, None] + t10[..., None]                      # T_10 p
    X, Y, Z = pc.unbind(1)
    px = cam.fx * X / Z + cam.u0
    py = cam.fy * Y / Z + cam.v0
    b = sfm["valid_border"]
    valid = ((Z > sfm["min_dpt"]) & (px >= b) & (px < cam.width - b)
             & (py >= b) & (py < cam.height - b))
    px = torch.where(valid, px, torch.zeros_like(px))
    py = torch.where(valid, py, torch.zeros_like(py))
    planes = torch.cat([inp.images[d][:, None],
                        inp.grads[d].permute(0, 3, 1, 2)], 1)
    i1, gx, gy = _sample(planes, px, py).unbind(1)
    r = inp.images[s].reshape(-1, H * W) - i1
    delta = sfm["huber_delta"]
    ar = r.abs()
    w = torch.where(ar <= delta, torch.ones_like(r),
                    torch.sqrt(delta * (2 * ar - delta)) / ar.clamp(min=1e-12))
    # dI/dp' [F, N, 3]
    iz = 1.0 / Z
    a = torch.stack([gx * cam.fx * iz, gy * cam.fy * iz,
                     -(gx * cam.fx * X + gy * cam.fy * Y) * iz * iz], -1)
    v = (pc - t10[..., None]).transpose(1, 2)                     # R_10 p
    dxi = torch.cat([a, torch.linalg.cross(v, a, dim=-1)], -1)    # [F, N, 6]
    z3 = torch.zeros_like(R1T)
    d_src = torch.cat([torch.cat([R1T, z3], -1), torch.cat([z3, R1T], -1)], -2)
    Wt = -R1T @ skew(t[d] - t[s])
    d_dst = torch.cat([torch.cat([-R1T, Wt], -1),
                       torch.cat([z3, -R1T], -1)], -2)
    # d depth / d prx
    ddp = -sfm["avg_dpt"] / (prx * prx)
    dz = (a * m.transpose(1, 2)).sum(-1) * ddp                    # [F, N]
    J = -torch.cat([dxi @ d_src, dxi @ d_dst, dz[..., None] * jac], -1)
    Jw = torch.where(valid[..., None], J * w[..., None], torch.zeros_like(J))
    rw = torch.where(valid, r * w, torch.zeros_like(r))
    JwT = Jw.transpose(1, 2)
    return JwT @ Jw, (JwT @ rw[..., None])[..., 0], rw.square().sum()


def schur_solve(H: Tensor, b: Tensor, K: int, CS: int, lam: float):
    """The damped step -(H + lam diag(H) + 1e-8 I)^-1 b with the code blocks
    (block-diagonal: a factor touches one code) eliminated first. A system
    that is not positive definite gives NaN."""
    Dp = 6 * K
    A = H + torch.diag(lam * torch.diagonal(H) + 1e-8)
    Axx, Axc = A[:Dp, :Dp], A[:Dp, Dp:].reshape(Dp, K, CS)
    k = torch.arange(K, device=H.device)
    C = A[Dp:, Dp:].reshape(K, CS, K, CS)[k, :, k, :]
    U = torch.cat([Axc.permute(1, 2, 0), b[Dp:].reshape(K, CS, 1)], -1)
    X = torch.cholesky_solve(U, _cholesky(C))           # C^-1 [A_cx | b_c]
    S = Axx - torch.einsum("pkc,kcq->pq", Axc, X[..., :Dp])
    rhs = b[:Dp] - torch.einsum("pkc,kc->p", Axc, X[..., Dp])
    dx = -torch.cholesky_solve(rhs[:, None], _cholesky(S))[:, 0]
    dc = -(X[..., Dp] + torch.einsum("kcp,p->kc", X[..., :Dp], dx))
    return torch.cat([dx, dc.reshape(-1)])


def _cholesky(A: Tensor) -> Tensor:
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


PRECISIONS = ("float64", "float32", "tf32")


def _dtype(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def normal_equations(inp: Inputs, q, t, codes, cam, sfm, priors,
                     precision="float64"):
    """The whole system at (q, t, codes), priors included: (H [D, D],
    b [D], cost), summed in ``precision``. Layout: [pose k (t, w) for
    each k | code k for each k]."""
    K, CS = codes.shape
    D = K * (6 + CS)
    dev = q.device
    dt = _dtype(precision)
    H = torch.zeros((D, D), dtype=dt, device=dev)
    b = torch.zeros((D,), dtype=dt, device=dev)
    cost = torch.zeros((), dtype=dt, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        P = inp.src.shape[0]
        ar = torch.arange(6, device=dev)
        for a in range(0, P, CHUNK):
            f = slice(a, min(P, a + CHUNK))
            JtJ, Jtr, c = linearise(inp, q, t, codes, cam, sfm, f)
            s, d = inp.src[f], inp.dst[f]
            idx = torch.cat([6 * s[:, None] + ar, 6 * d[:, None] + ar,
                             6 * K + CS * s[:, None]
                             + torch.arange(CS, device=dev)], 1)
            H.index_put_((idx[:, :, None].expand_as(JtJ).reshape(-1),
                          idx[:, None, :].expand_as(JtJ).reshape(-1)),
                         JtJ.to(dt).reshape(-1), accumulate=True)
            b.index_add_(0, idx.reshape(-1), Jtr.to(dt).reshape(-1))
            cost += c.to(dt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    # priors: zero codes, keyframe 0 at the origin
    wc = 1.0 / priors["code_prior"] ** 2
    ci = torch.arange(6 * K, D, device=dev)
    H[ci, ci] += wc
    b[ci] += wc * codes.to(dt).reshape(-1)
    wp = 1.0 / priors["pose_prior"] ** 2
    pi = torch.arange(6, device=dev)
    r0 = torch.cat([t[0], log_quat(q[0])]).to(dt)
    H[pi, pi] += wp
    b[:6] += wp * r0
    cost += wc * codes.to(dt).square().sum() + wp * r0.square().sum()
    return H, b, cost


def gn_step(inp: Inputs, q, t, codes, cam, sfm, priors,
            precision="float64"):
    """One damped Gauss-Newton step over every factor: (q, t, codes), the
    system summed and solved in ``precision``."""
    K, CS = codes.shape
    H, b, _ = normal_equations(inp, q, t, codes, cam, sfm, priors,
                               precision)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        dx = schur_solve(H, b, K, CS, priors["lam"]).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    qn, tn = retract(q, t, dx[:6 * K].reshape(K, 6))
    return qn, tn, codes + dx[6 * K:].reshape(K, CS)


def solve(inp: Inputs, q0: Tensor, t0: Tensor, cam, sfm: dict, priors: dict,
          iters: int, precision: str = "float64"):
    """``iters`` steps from (q0, t0) and zero codes: (q, t, codes)."""
    K, CS = inp.jac.shape[0], inp.jac.shape[-1]
    q, t = q0, t0
    codes = torch.zeros((K, CS), device=q0.device)
    with torch.no_grad():
        for _ in range(iters):
            q, t, codes = gn_step(inp, q, t, codes, cam, sfm, priors,
                                  precision)
    return q, t, codes


def rotation_gap(qa: Tensor, qb: Tensor) -> Tensor:
    """Angle (rad) of the rotation between two quaternions, per row."""
    qa = qa / qa.norm(dim=-1, keepdim=True)
    qb = qb / qb.norm(dim=-1, keepdim=True)
    d = quat_product(qa * torch.tensor([1.0, -1.0, -1.0, -1.0],
                                       dtype=qa.dtype, device=qa.device), qb)
    return 2.0 * torch.atan2(d[..., 1:].norm(dim=-1), d[..., 0].abs())


def gaps(q, t, c, qr, tr, cr, system=None) -> dict:
    """What the check reads, over the keyframes of one solve: the largest
    translation gap (m), rotation gap (rad) and code gap; and, given the
    reference's system (H, cost) at its own solution, ``h_gap``: the gap
    d^T H d in the tangent of the reference's solution (d: t - tr,
    log(R Rr^T), c - cr per keyframe) over the cost there, about twice the
    relative rise of the cost from the reference's solution to the
    compared one. It weighs each direction by how far the data determine
    it, so the directions they leave nearly free (a scale that codes and
    translations trade, a keyframe at the end of the chain) count little."""
    keys = ("t_gap_m", "r_gap_rad", "code_gap") + (
        ("h_gap",) if system is not None else ())
    fin = lambda x: bool(torch.isfinite(x).all())
    if not (fin(q) and fin(t) and fin(c)):
        return {k: float("nan") for k in keys}
    out = {"t_gap_m": float((t - tr).norm(dim=-1).max()),
           "r_gap_rad": float(rotation_gap(q.double(), qr.double()).max()),
           "code_gap": float((c - cr).abs().max())}
    if system is not None:
        H, cost = system
        qc = qr * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=qr.dtype,
                               device=qr.device)
        w = log_quat(quat_product(q.double(), qc.double()))
        d = torch.cat([torch.cat([(t - tr).double(), w], 1).reshape(-1),
                       (c - cr).double().reshape(-1)])
        out["h_gap"] = float(d @ (H.double() @ d) / cost)
    return out
