"""Fused dense-SfM linearisations: the counterpart of
``deepfactors_tpu/ops/pallas/sfm_kernel.py``.

Two functions carry the system's hot path, each with a hand-written CUDA
kernel (``csrc/se3_gram.cu``, ``csrc/sfm_gram.cu``) and a plain PyTorch
twin in this module:

  - ``se3_gram_batch``: SE(3) tracking linearisation, G [P, 8, 8] with
    rows ``[-w·A(6) | w·r | valid]`` (JtJ = G[:6,:6], Jtr = G[:6,6],
    residual = G[6,6], inliers = G[7,7]).
  - ``sfm_gram_batch``: photometric BA linearisation straight from the
    keyframe pools, G [P, R, R], R = 6 + CS + 2, rows
    ``[w·A(6) | w·err_J_prx·jac(CS) | w·r | valid]``.

``system_from_gram`` (plain PyTorch, fp32) expands an SfM Gram stack into
the reference's 44-dim [pose0 | pose1 | code0] factor systems.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain twin. Nothing falls back from one to the other. Every kernel
launch adds one to ``LAUNCHES[name]``.

Both kernels, and the two of ``sfm_error.py``, are one launch a call.
``launch_plan`` owns the geometry of all four in plain Python (strips, the
8 x 8 register tiles of the SfM Gram and the threads that own them, the map
from the kernel's rows to G's, shared memory, scratch shapes), so the CPU
tests reach what the kernels are handed; the sources derive none of it and
only hold it against their block size and shared memory. A block writes one
partial per pixel strip; the last block of a factor to finish, found with
an integer ticket, sums the partials in a fixed order and writes the
result, so results are bitwise reproducible. The tickets are a buffer per
(device, stream) that all four kernels share, all zero between launches:
calls on one stream are ordered, and two streams never share a buffer.
``make_sfm_params`` keeps the constant part of its rows on the device.

Semantics follow the TPU kernels except for their band-gather machinery
(``_band_sample*`` and the ``cover`` mask, a workaround for Mosaic's in-tile
gather): here every pixel samples the target image directly, so coverage is
always complete — the same as the JAX package's XLA path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...geometry import se3 as se3m
from ...geometry.camera import PinholeCamera
from ..image import bilinear_sample_grad
from . import build

Tensor = torch.Tensor

# params vector layout (per factor)
PARAM_DIM = 24
_R0, _T0, _FX, _FY, _U0, _V0 = 0, 9, 12, 13, 14, 15
_BORDER, _MINDPT, _HUBER, _AVGDPT = 16, 17, 18, 19

MAX_CODE_SIZE = 64
_GRAD_MODES = {"interp": 0, "sampled": 1}
_LOSSES = {"huber": 0, "tukey": 1}

# launch counters of the CUDA kernels (plain-twin calls never count)
LAUNCHES = {"se3_gram_batch": 0, "sfm_gram_batch": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# (camera intrinsics, border, min_dpt, huber, avg_dpt, device) -> the constant
# tail [1, PARAM_DIM - 12] of a params row, kept on the device so that a
# call copies nothing from the host
_CONST_ROWS: dict = {}
_CONST_ROWS_MAX = 256


def _const_row(cam: PinholeCamera, border, min_dpt, huber_delta, avg_dpt,
               device) -> Tensor:
    vals = (cam.fx, cam.fy, cam.u0, cam.v0, float(border), float(min_dpt),
            float(huber_delta), float(avg_dpt))
    key = (vals, str(device))
    row = _CONST_ROWS.get(key)
    if row is None:
        if len(_CONST_ROWS) >= _CONST_ROWS_MAX:
            _CONST_ROWS.clear()
        row = torch.tensor([vals + (0.0,) * (PARAM_DIM - 20)],
                           dtype=torch.float32, device=device)
        _CONST_ROWS[key] = row
    return row


def make_sfm_params(pose_10: se3m.SE3, cam: PinholeCamera, border, min_dpt,
                    huber_delta, avg_dpt) -> Tensor:
    """Pack per-factor scalars: R(9) t(3) fx fy u0 v0 border min_dpt huber
    avg_dpt, padded to PARAM_DIM. pose_10 is batched [P]."""
    R = se3m.quat_to_matrix(pose_10.q)
    P = R.shape[0]
    const = _const_row(cam, border, min_dpt, huber_delta, avg_dpt, R.device)
    return torch.cat([R.reshape(P, 9), pose_10.t,
                      const.expand(P, PARAM_DIM - 12)], dim=-1)


# ----------------------------------------------------------------------------
# plain PyTorch twins
# ----------------------------------------------------------------------------

def _param_col(params: Tensor, k: int) -> Tensor:
    return params[:, k:k + 1]


class _Corr(NamedTuple):
    """Per-pixel correspondence of P factors, each field [P, N] (the scalars
    [P, 1]), in the op order of csrc/sfm_common.cuh::correspondence."""

    x1: Tensor
    y1: Tensor
    valid: Tensor
    iz: Tensor
    u: Tensor
    v: Tensor
    tptx: Tensor
    tpty: Tensor
    tptz: Tensor


def _correspondence(params, dpt) -> _Corr:
    """FindCorrespondence of every pixel of dpt [P, H, W] under each factor's
    params row. Invalid pixels keep their own coordinates and iz = 0."""
    P, H, W = dpt.shape
    dev = dpt.device
    xs = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)
    ys = torch.arange(H, dtype=torch.float32, device=dev).repeat_interleave(W)
    c = lambda k: _param_col(params, k)
    R = [c(_R0 + k) for k in range(9)]
    tx, ty, tz = c(_T0), c(_T0 + 1), c(_T0 + 2)
    fx, fy, u0, v0 = c(_FX), c(_FY), c(_U0), c(_V0)
    border, min_dpt = c(_BORDER), c(_MINDPT)

    d = dpt.reshape(P, -1)
    u = (xs - u0) / fx
    v = (ys - v0) / fy
    ptx = u * d
    pty = v * d
    tptx = R[0] * ptx + R[1] * pty + R[2] * d + tx
    tpty = R[3] * ptx + R[4] * pty + R[5] * d + ty
    tptz = R[6] * ptx + R[7] * pty + R[8] * d + tz
    zsafe = torch.where(tptz.abs() > 1e-12, tptz, torch.full_like(tptz, 1e-12))
    x1 = fx * tptx / zsafe + u0
    y1 = fy * tpty / zsafe + v0
    valid = ((tptz > min_dpt) & (x1 >= border) & (x1 < W - border)
             & (y1 >= border) & (y1 < H - border))
    x1 = torch.where(valid, x1, xs)
    y1 = torch.where(valid, y1, ys)
    iz = torch.where(valid, 1.0 / zsafe, torch.zeros_like(zsafe))
    return _Corr(x1, y1, valid, iz, u, v, tptx, tpty, tptz)


def _robust_wv(r, valid, delta, loss):
    """Square-root IRLS weight zeroed on invalid pixels
    (csrc/sfm_common.cuh::robust_wv)."""
    if loss == "tukey":
        a = r / delta
        w = torch.clamp(1.0 - a * a, min=0.0)
    elif loss == "huber":
        aa = r.abs()
        hub = torch.sqrt(delta * (2.0 * aa - delta)) / torch.clamp(aa, min=1e-12)
        w = torch.where(aa <= delta, torch.ones_like(hub), hub)
    else:
        raise ValueError(f"unknown loss {loss!r}")
    return torch.where(valid, w, torch.zeros_like(w))


def _warp_rows(params, dpt, img0, img1, gx1, gy1, grad_mode, loss):
    """Per-pixel warp math of the kernels, batched over factors.

    dpt/img0/img1(/gx1/gy1) are per-factor planes [P, H, W]. Returns
    (A [6 x [P, N]], err_J_prx [P, N], r [P, N], wv [P, N], valid [P, N]),
    in the op order of csrc/sfm_common.cuh."""
    P = dpt.shape[0]
    c = lambda k: _param_col(params, k)
    R = [c(_R0 + k) for k in range(9)]
    tx, ty, tz = c(_T0), c(_T0 + 1), c(_T0 + 2)
    fx, fy = c(_FX), c(_FY)
    huber, avg = c(_HUBER), c(_AVGDPT)
    d = dpt.reshape(P, -1)
    x1, y1, valid, iz, u, v, tptx, tpty, tptz = _correspondence(params, dpt)

    pix = torch.stack([x1, y1], dim=-1)
    if grad_mode == "interp":
        i1, gx, gy = bilinear_sample_grad(img1, pix)
    elif grad_mode == "sampled":
        i1 = bilinear_sample_grad(img1, pix)[0]
        gx = bilinear_sample_grad(gx1, pix)[0]
        gy = bilinear_sample_grad(gy1, pix)[0]
    else:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")

    d00 = fx * iz
    d02 = -fx * tptx * iz * iz
    d11 = fy * iz
    d12 = -fy * tpty * iz * iz
    gd0 = gx * d00
    gd1 = gy * d11
    gd2 = gx * d02 + gy * d12
    vx = tptx - tx
    vy = tpty - ty
    vz = tptz - tz
    A = [gd0, gd1, gd2, -gd1 * vz + gd2 * vy, gd0 * vz - gd2 * vx,
         -gd0 * vy + gd1 * vx]

    m0 = R[0] * u + R[1] * v + R[2]
    m1 = R[3] * u + R[4] * v + R[5]
    m2 = R[6] * u + R[7] * v + R[8]
    pjd0 = d00 * m0 + d02 * m2
    pjd1 = d11 * m1 + d12 * m2
    ad = avg + d
    dpt_J_prx = -(ad * ad) / avg
    err_J_prx = -(gx * pjd0 + gy * pjd1) * dpt_J_prx

    r = img0.reshape(P, -1) - i1
    wv = _robust_wv(r, valid, huber, loss)
    return A, err_J_prx, r, wv, valid


def _gram(rows, active):
    B = torch.stack(rows, dim=1)                     # [P, R, N]
    G = torch.matmul(B, B.transpose(1, 2))
    return torch.where(active[:, None, None] != 0, G, torch.zeros_like(G))


def _clamped(idx: Tensor, n: int) -> Tensor:
    return torch.clamp(idx.long(), 0, n - 1)


def _default_active(active, P, device):
    if active is None:
        return torch.ones(P, dtype=torch.int32, device=device)
    return active.to(torch.int32)


def se3_gram_batch_plain(params, src, dst, img0_pool, dpt_pool, img1_pool,
                         gx1_pool=None, gy1_pool=None, active=None,
                         grad_mode="sampled") -> Tensor:
    """Plain PyTorch version of ``se3_gram_batch`` (same arguments)."""
    K, K1 = img0_pool.shape[0], img1_pool.shape[0]
    s, d = _clamped(src, K), _clamped(dst, K1)
    active = _default_active(active, src.shape[0], img0_pool.device)
    sampled = grad_mode == "sampled"
    A, _, r, wv, valid = _warp_rows(
        params, dpt_pool[s], img0_pool[s], img1_pool[d],
        gx1_pool[d] if sampled else None, gy1_pool[d] if sampled else None,
        grad_mode, "huber")
    rows = [-wv * a for a in A] + [wv * r, valid.to(torch.float32)]
    return _gram(rows, active)


def sfm_gram_batch_plain(params, src, dst, img0_pool, dpt_pool, jacT_pool,
                         img1_pool, gx1_pool=None, gy1_pool=None, active=None,
                         codes=None, grad_mode="sampled",
                         loss="huber") -> Tensor:
    """Plain PyTorch version of ``sfm_gram_batch`` (same arguments)."""
    K, K1 = img0_pool.shape[0], img1_pool.shape[0]
    CS = jacT_pool.shape[1]
    s, d = _clamped(src, K), _clamped(dst, K1)
    active = _default_active(active, src.shape[0], img0_pool.device)
    jac = jacT_pool[s]                                    # [P, CS, H, W]
    if codes is not None:
        prx = dpt_pool[s]
        for c in range(CS):
            prx = prx + codes[:, c, None, None] * jac[:, c]
        prx = torch.clamp(prx, min=1e-4)
        avg = params[:, _AVGDPT, None, None]
        dpt = avg / prx - avg
    else:
        dpt = dpt_pool[s]
    sampled = grad_mode == "sampled"
    A, err_J_prx, r, wv, valid = _warp_rows(
        params, dpt, img0_pool[s], img1_pool[d],
        gx1_pool[d] if sampled else None, gy1_pool[d] if sampled else None,
        grad_mode, loss)
    sc = wv * err_J_prx
    P = src.shape[0]
    rows = ([wv * a for a in A]
            + list((sc[:, None, :] * jac.reshape(P, CS, -1)).unbind(1))
            + [wv * r, valid.to(torch.float32)])
    return _gram(rows, active)


# ----------------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------------

def _ptr(t: Tensor):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _check(t: Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(code: int, lib, fn_name: str):
    if code != 0:
        msg = getattr(lib, fn_name)(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({code})")


THREADS = 256            # threads per block of all four kernels
TILE = 8                 # edge of sfm_gram.cu's square register tile
_REDUCE_ROUND = 32       # accumulators per round of its block reduction
_STAGE_ROW = THREADS     # floats of one row of its input stage
_SMEM_MAX = 227 * 1024   # shared memory a block can opt in to on sm_90
_SM_COUNT = 132          # H100 SXM
_BLOCKS_PER_SM = 2       # resident blocks of either Gram kernel (registers)
_SFM_MAX_STRIPS = 12     # strips per factor at most (sfm_gram_batch)
_SE3_MAX_PX = 8          # pixels a thread at most (se3_gram_batch)
# sfm_error.cu: resident blocks an SM (__launch_bounds__(256, 4)), pixels a
# thread at most (one batch of loads) unless the strips would outnumber a
# block's threads
_ERR_BLOCKS_PER_SM = 4
_ERR_MAX_PX = 4
_ERR_KERNELS = ("sfm_error_batch", "se3_warp_batch")


class LaunchPlan(NamedTuple):
    """How a kernel of this module is launched on one call's shapes."""

    grid: tuple           # THREADS-thread blocks: (strips, P); sfm_gram (P, strips)
    px_per_blk: int       # pixels of a strip
    nblk: int             # strips per factor
    R: int                # rows of G (0: the error kernels)
    Rp: int               # R padded up to the register tile
    tiles: tuple          # (block row, block column) of every register tile
    lanes: int            # threads per pixel slice (tile count rounded up)
    nslices: int          # pixel slices that share one tile of pixels
    steps: int            # pixels of a tile that one slice walks
    tile_px: int          # pixels built per tile = nslices * steps
    stride: int           # floats between two pixels' rows in shared memory
    stage_off: int        # floats before the input stage in shared memory
    smem_bytes: int       # dynamic shared memory of a block
    table: tuple          # what the kernel reads: every tile's block row, every
                          # tile's block column, then for each of the Rp rows
                          # of shared memory its row of G (-1: padding)
    part_shape: tuple     # scratch: one partial per (factor, strip)
    ticket_shape: tuple   # int32 tickets, one per factor


def public_row(q: int, CS: int) -> int:
    """Row of G that row ``q`` of sfm_gram.cu's shared-memory layout
    [jac(CS) | A(6) | w*r | valid] lands in ([A | jac | w*r | valid])."""
    if q < CS:
        return q + 6
    if q < CS + 6:
        return q - CS
    return q


@functools.lru_cache(maxsize=256)
def launch_plan(name: str, P: int, H: int, W: int, CS: int = 0) -> LaunchPlan:
    """The launch geometry of ``se3_gram_batch``, ``sfm_gram_batch``,
    ``sfm_error_batch``, ``se3_warp_batch`` or ``bilinear_warp_planes`` for
    P factors on H x W planes (code size CS): what the wrappers hand to
    csrc/se3_gram.cu, csrc/sfm_gram.cu, csrc/sfm_error.cu and
    csrc/dense_warp.cu, which derive none of it. Plans are cached by their
    arguments; the module's constants are read when a plan is first made."""
    N = H * W
    slots = _BLOCKS_PER_SM * _SM_COUNT
    strips1 = -(-N // THREADS)
    if name == "se3_gram_batch":
        # one pixel a thread; more only where the blocks would not all be
        # resident at once
        ppt = min(_SE3_MAX_PX, max(1, -(-strips1 * P // slots)))
        per = THREADS * ppt
        nblk = -(-N // per)
        return LaunchPlan((nblk, P), per, nblk, 8, 8, (), 0, 0, 0, 0, 0, 0, 0,
                          (), (P, nblk, 36), (P,))
    if name in _ERR_KERNELS:
        # the same rule with the error kernels' residency; the last block of
        # a factor reads one strip's partial a thread, so at most THREADS
        # strips
        err_slots = _ERR_BLOCKS_PER_SM * _SM_COUNT
        ppt = min(_ERR_MAX_PX, max(1, -(-strips1 * P // err_slots)))
        ppt = max(ppt, -(-strips1 // THREADS))
        per = THREADS * ppt
        nblk = -(-N // per)
        return LaunchPlan((nblk, P), per, nblk, 0, 0, (), 0, 0, 0, 0, 0, 0, 0,
                          (), (P, nblk, 2), (P,))
    if name == "bilinear_warp_planes":
        # one set of coordinates (P = 1), one pixel a thread; no scratch
        if P != 1:
            raise ValueError("bilinear_warp_planes samples one set of planes")
        return LaunchPlan((strips1, 1), THREADS, strips1, 0, 0, (), 0, 0, 0,
                          0, 0, 0, 0, (), (), ())
    if name != "sfm_gram_batch":
        raise ValueError(f"no launch plan for {name!r}")
    if not 1 <= CS <= MAX_CODE_SIZE:
        raise ValueError(f"code size {CS} is not in 1..{MAX_CODE_SIZE}")
    R = CS + 8
    nb = -(-R // TILE)
    Rp = nb * TILE
    tiles = tuple((i, j) for i in range(nb) for j in range(i, nb))
    n = len(tiles)
    # lanes of one pixel slice: a power of two below 16, else a multiple of
    # 16, so that a warp's lanes sit at no more than two pixels
    lanes = 1 << (n - 1).bit_length() if n <= 8 else -(-n // 16) * 16
    nslices = THREADS // lanes
    stride = Rp + 4
    # pixels of a tile: every slice walks ``steps`` of them; a multiple of 4
    # (16-byte rows for the bulk copies) that fits shared memory
    steps = THREADS // nslices
    while steps > 1 and (nslices * steps) % 4:
        steps -= 1
    tile_px = nslices * steps
    # the rows of a tile and, after the strip, the block reduction share the
    # front of shared memory; the input stage follows
    stage_off = max(tile_px * stride, _REDUCE_ROUND * THREADS)
    smem = 4 * (stage_off + (CS + 2) * _STAGE_ROW)
    if smem > _SMEM_MAX:
        raise ValueError(f"code size {CS} needs {smem} bytes of shared memory")
    # strips: about two rounds of resident blocks if every factor is active
    want = min(_SFM_MAX_STRIPS, max(2, round(2 * slots / P)))
    per = -(-N // want)
    per = max(1, -(-per // tile_px)) * tile_px
    nblk = -(-N // per)
    table = (tuple(i for i, _ in tiles) + tuple(j for _, j in tiles)
             + tuple(public_row(q, CS) if q < R else -1 for q in range(Rp)))
    return LaunchPlan((P, nblk), per, nblk, R, Rp, tiles, lanes, nslices,
                      steps, tile_px, stride, stage_off, smem, table,
                      (P, nblk, n * TILE * TILE), (P,))


# (device index, stream) -> int32 tickets, all zero between launches: each
# kernel's last block per factor resets its ticket. One buffer per stream:
# launches on one stream are ordered, launches on two streams are not.
_TICKETS: dict = {}


def _tickets(dev: torch.device, stream: int, P: int) -> Tensor:
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.shape[0] < P:
        t = _TICKETS[key] = torch.zeros(max(P, 256), dtype=torch.int32,
                                        device=dev)
    return t


def _drop_tickets(dev: torch.device, stream: int) -> None:
    """After a failed launch: the next call on this stream gets fresh zeros,
    whatever the failed one left in its tickets."""
    _TICKETS.pop((dev.index, stream), None)


# (code size, device index) -> a plan's ``table`` as int32 on the device
_TABLES: dict = {}


def _table(plan: LaunchPlan, CS: int, dev: torch.device) -> Tensor:
    key = (CS, dev.index)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.tensor(plan.table, dtype=torch.int32,
                                        device=dev)
    return t


_SIGS = {}


def _lib(source: str, fn: str, err_fn: str, nargs_ptr: int, nargs_int: int):
    lib = build.library(source)
    if (source, fn) not in _SIGS:
        f = getattr(lib, fn)
        f.argtypes = ([ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        getattr(lib, err_fn).restype = ctypes.c_char_p
        getattr(lib, err_fn).argtypes = [ctypes.c_int]
        _SIGS[(source, fn)] = True
    return lib


def empty_launch(device) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream: the
    floor under any single launch, for timing beside the kernels."""
    lib = _lib("se3_gram.cu", "empty_launch", "se3_gram_error_string", 0, 0)
    code = lib.empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _raise_on(code, lib, "se3_gram_error_string")


def _se3_gram_cuda(params, src, dst, img0_pool, dpt_pool, img1_pool,
                   gx1_pool, gy1_pool, active, grad_mode):
    dev = img0_pool.device
    P = src.shape[0]
    K, H, W = img0_pool.shape
    K1 = img1_pool.shape[0]
    if grad_mode not in _GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    f32, i32 = torch.float32, torch.int32
    _check(params, "params", f32, (P, PARAM_DIM), dev)
    _check(src, "src", i32, (P,), dev)
    _check(dst, "dst", i32, (P,), dev)
    if active is not None:      # None: the kernel takes every factor as active
        active = active.to(i32)
        _check(active, "active", i32, (P,), dev)
    _check(img0_pool, "img0_pool", f32, (K, H, W), dev)
    _check(dpt_pool, "dpt_pool", f32, (K, H, W), dev)
    _check(img1_pool, "img1_pool", f32, (K1, H, W), dev)
    if grad_mode == "sampled":
        _check(gx1_pool, "gx1_pool", f32, (K1, H, W), dev)
        _check(gy1_pool, "gy1_pool", f32, (K1, H, W), dev)
    else:
        gx1_pool = gy1_pool = None
    plan = launch_plan("se3_gram_batch", P, H, W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty(plan.part_shape, dtype=f32, device=dev)
    G = torch.empty((P, 8, 8), dtype=f32, device=dev)
    lib = _lib("se3_gram.cu", "se3_gram_launch", "se3_gram_error_string",
               12, 8)
    code = lib.se3_gram_launch(
        _ptr(params), _ptr(src), _ptr(dst), _ptr(active), _ptr(img0_pool),
        _ptr(dpt_pool), _ptr(img1_pool), _ptr(gx1_pool), _ptr(gy1_pool),
        _ptr(part), _ptr(G), _ptr(_tickets(dev, stream, P)), P, K, K1, H, W,
        plan.px_per_blk, plan.nblk, _GRAD_MODES[grad_mode],
        ctypes.c_void_p(stream))
    if code != 0:
        _drop_tickets(dev, stream)
    _raise_on(code, lib, "se3_gram_error_string")
    LAUNCHES["se3_gram_batch"] += 1
    return G


def _sfm_gram_cuda(params, src, dst, img0_pool, dpt_pool, jacT_pool,
                   img1_pool, gx1_pool, gy1_pool, active, codes, grad_mode,
                   loss):
    dev = img0_pool.device
    P = src.shape[0]
    K, H, W = img0_pool.shape
    K1 = img1_pool.shape[0]
    CS = jacT_pool.shape[1]
    if CS > MAX_CODE_SIZE:
        raise ValueError(f"code size {CS} > {MAX_CODE_SIZE} is not supported")
    if grad_mode not in _GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    if loss not in _LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    f32, i32 = torch.float32, torch.int32
    _check(params, "params", f32, (P, PARAM_DIM), dev)
    _check(src, "src", i32, (P,), dev)
    _check(dst, "dst", i32, (P,), dev)
    if active is not None:      # None: the kernel takes every factor as active
        active = active.to(i32)
        _check(active, "active", i32, (P,), dev)
    _check(img0_pool, "img0_pool", f32, (K, H, W), dev)
    _check(dpt_pool, "dpt_pool", f32, (K, H, W), dev)
    _check(jacT_pool, "jacT_pool", f32, (K, CS, H, W), dev)
    _check(img1_pool, "img1_pool", f32, (K1, H, W), dev)
    if grad_mode == "sampled":
        _check(gx1_pool, "gx1_pool", f32, (K1, H, W), dev)
        _check(gy1_pool, "gy1_pool", f32, (K1, H, W), dev)
    else:
        gx1_pool = gy1_pool = None
    if codes is not None:
        _check(codes, "codes", f32, (P, CS), dev)
    plan = launch_plan("sfm_gram_batch", P, H, W, CS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty(plan.part_shape, dtype=f32, device=dev)
    G = torch.empty((P, plan.R, plan.R), dtype=f32, device=dev)
    lib = _lib("sfm_gram.cu", "sfm_gram_launch", "sfm_gram_error_string",
               15, 19)
    code = lib.sfm_gram_launch(
        _ptr(params), _ptr(src), _ptr(dst), _ptr(active), _ptr(codes),
        _ptr(img0_pool), _ptr(dpt_pool), _ptr(jacT_pool), _ptr(img1_pool),
        _ptr(gx1_pool), _ptr(gy1_pool), _ptr(part), _ptr(G),
        _ptr(_tickets(dev, stream, P)), _ptr(_table(plan, CS, dev)),
        P, K, K1, CS, H, W, plan.px_per_blk, plan.nblk, plan.Rp,
        len(plan.tiles), plan.lanes, plan.nslices, plan.steps, plan.stride,
        plan.stage_off, plan.smem_bytes,
        _GRAD_MODES[grad_mode], _LOSSES[loss], int(codes is not None),
        ctypes.c_void_p(stream))
    if code != 0:
        _drop_tickets(dev, stream)
    _raise_on(code, lib, "sfm_gram_error_string")
    LAUNCHES["sfm_gram_batch"] += 1
    return G


# ----------------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------------

def _route(t: Tensor) -> str:
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for tensors on {t.device}")


def se3_gram_batch(params, src, dst, img0_pool, dpt_pool, img1_pool,
                   gx1_pool=None, gy1_pool=None, active=None,
                   grad_mode="sampled") -> Tensor:
    """Fused SE(3) tracking linearisation: G [P, 8, 8].

    params [P, PARAM_DIM] (make_sfm_params), src/dst [P] int32 slots into
    the keyframe pools img0/dpt [K, H, W] and the live pools
    img1(/gx1/gy1) [K1, H, W]; active [P] (0 = G is zero; None: every
    factor active)."""
    if _route(img0_pool) == "cuda":
        return _se3_gram_cuda(params, src, dst, img0_pool, dpt_pool,
                              img1_pool, gx1_pool, gy1_pool, active, grad_mode)
    return se3_gram_batch_plain(params, src, dst, img0_pool, dpt_pool,
                                img1_pool, gx1_pool, gy1_pool, active,
                                grad_mode)


def sfm_gram_batch(params, src, dst, img0_pool, dpt_pool, jacT_pool,
                   img1_pool, gx1_pool=None, gy1_pool=None, active=None,
                   codes=None, grad_mode="sampled", loss="huber") -> Tensor:
    """Fused SfM linearisation: G [P, R, R], R = 6 + CS + 2.

    jacT_pool [K, CS, H, W] is the feature-major code Jacobian. With
    ``codes`` [P, CS] given, dpt_pool holds the zero-code proximity prx0
    and depth is materialised per factor at its code."""
    if _route(img0_pool) == "cuda":
        return _sfm_gram_cuda(params, src, dst, img0_pool, dpt_pool, jacT_pool,
                              img1_pool, gx1_pool, gy1_pool, active, codes,
                              grad_mode, loss)
    return sfm_gram_batch_plain(params, src, dst, img0_pool, dpt_pool,
                                jacT_pool, img1_pool, gx1_pool, gy1_pool,
                                active, codes, grad_mode, loss)


def system_from_gram(G: Tensor, j_pose0: Tensor, j_pose1: Tensor, CS: int):
    """Expand Gram stacks into reference-layout GN systems.

    G [P, R, R] with R = 6+CS+2. Returns (JtJ [P, 12+CS, 12+CS],
    Jtr [P, 12+CS], residual [P], inliers [P]) in the reference row layout
    [dErr/dpose0 | dErr/dpose1 | dErr/dcode0] (photometric_factor.cpp:
    135-161) via J = M·B with M = [[-j_pose0ᵀ·sel_A], [-j_pose1ᵀ·sel_A],
    [sel_code]]. Plain fp32 matmuls; the pose blocks are symmetrised
    explicitly so the downstream Cholesky sees exactly symmetric systems."""
    DB = 6 + CS
    g = G[:, :DB, DB]
    residual = G[:, DB, DB]
    inliers = G[:, DB + 1, DB + 1]
    sym = lambda X: 0.5 * (X + X.transpose(-1, -2))
    T0 = j_pose0.transpose(-1, -2)
    T1 = j_pose1.transpose(-1, -2)
    GA = sym(G[:, :6, :6])
    GAc = G[:, :6, 6:DB]
    Gcc = sym(G[:, 6:DB, 6:DB])
    gA = g[:, :6, None]
    gc = g[:, 6:]
    T0GA = T0 @ GA
    T1GA = T1 @ GA
    B00 = sym(T0GA @ T0.transpose(-1, -2))
    B01 = T0GA @ T1.transpose(-1, -2)
    B11 = sym(T1GA @ T1.transpose(-1, -2))
    B0c = -(T0 @ GAc)
    B1c = -(T1 @ GAc)
    t = lambda X: X.transpose(-1, -2)
    JtJ = torch.cat([
        torch.cat([B00, B01, B0c], dim=-1),
        torch.cat([t(B01), B11, B1c], dim=-1),
        torch.cat([t(B0c), t(B1c), Gcc], dim=-1),
    ], dim=-2)
    Jtr = torch.cat([-(T0 @ gA)[..., 0], -(T1 @ gA)[..., 0], gc], dim=-1)
    return JtJ, Jtr, residual, inliers
