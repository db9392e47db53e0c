"""The weighted Jacobian stack of the unfused photometric linearisation
(``ops/kernels/jacobian_stack``): its plain twin and ``sfm_step_batch``
held bit for bit to a copy of the eager chain the port ran before the
kernel (kept below as it was), under the Huber and Tukey losses, with
invalid pixels (behind the camera, outside the border) and pixels at
tptz ~ 0, at code sizes 8 and 32 and two chunk sizes; the wrapper's
argument checks and launch plan; CPU tensors never launch the kernel."""
import numpy as np
import pytest
import torch

from deepfactors_tpu_torch.geometry import se3 as se3m
from deepfactors_tpu_torch.geometry import warping as wp
from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.geometry.m_estimators import (huber_weight,
                                                         tukey_sqrt_weight)
from deepfactors_tpu_torch.geometry.se3 import SE3
from deepfactors_tpu_torch.ops import dense_sfm as ds
from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
from deepfactors_tpu_torch.ops.kernels import jacobian_stack as js
from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

H, W = 24, 40
BORDER, MIN_DPT = 2, 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    """Every comparison on one intra-op thread. The twin and the eager copy
    broadcast some operands differently (fx as a column or a float), so
    their elementwise ops split across threads differently; where a worker
    thread's floating-point mode (flush to zero) differs from the main
    thread's, a denormal would round in one and not in the other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------------
# the eager chain before the kernel, as it was (ops/dense_sfm.py)
# ----------------------------------------------------------------------------

def _eager_robust_weight(r, delta, loss):
    if loss == "tukey":
        return tukey_sqrt_weight(r, delta)
    return huber_weight(r, delta)


def _eager_warp_jacobians(warp, dpt, cam, pose_10, gx, gy, avg_dpt):
    x, y, z = warp.tptx, warp.tpty, warp.tptz
    iz = 1.0 / z
    d00 = cam.fx * iz
    d02 = -cam.fx * x * iz * iz
    d11 = cam.fy * iz
    d12 = -cam.fy * y * iz * iz
    gd0 = gx * d00
    gd1 = gy * d11
    gd2 = gx * d02 + gy * d12
    t10 = pose_10.t[..., None]
    vx = x - t10[..., 0, :]
    vy = y - t10[..., 1, :]
    vz = z - t10[..., 2, :]
    A = torch.stack([gd0, gd1, gd2, -gd1 * vz + gd2 * vy,
                     gd0 * vz - gd2 * vx, -gd0 * vy + gd1 * vx], dim=-2)
    R = se3m.quat_to_matrix(pose_10.q)[..., None]
    u, v = warp.u, warp.v
    m0 = R[..., 0, 0, :] * u + R[..., 0, 1, :] * v + R[..., 0, 2, :]
    m1 = R[..., 1, 0, :] * u + R[..., 1, 1, :] * v + R[..., 1, 2, :]
    m2 = R[..., 2, 0, :] * u + R[..., 2, 1, :] * v + R[..., 2, 2, :]
    pjd0 = d00 * m0 + d02 * m2
    pjd1 = d11 * m1 + d12 * m2
    dpt_J_prx = wp.depth_jacobian_prx(dpt, avg_dpt)
    err_J_prx = -(gx * pjd0 + gy * pjd1) * dpt_J_prx
    return A, err_J_prx


def _eager_chunk(cam, pose_10, j_pose0, j_pose1, u, v, warp, dpt, img0, jac0,
                 params, loss):
    """One chunk of the eager chain: (Jw, rw, valid)."""
    i1, gx, gy, tptx, tpty, tptz, validf = warp
    N = H * W
    CS = jac0.shape[-1]
    flat = lambda x: x.reshape(-1, N)
    fields = ds.DenseWarp(u, v, flat(tptx), flat(tpty), flat(tptz), None,
                          None, flat(validf) > 0.5)
    A, err_J_prx = _eager_warp_jacobians(fields, flat(dpt), cam, pose_10,
                                         flat(gx), flat(gy), params.avg_dpt)
    JT = torch.cat([
        -(j_pose0.transpose(-1, -2) @ A),
        -(j_pose1.transpose(-1, -2) @ A),
        err_J_prx[:, None, :] * jac0.reshape(-1, N, CS).transpose(1, 2),
    ], dim=1)
    r = flat(img0) - flat(i1)
    w = _eager_robust_weight(r, params.huber_delta, loss)
    wv = torch.where(fields.valid, w, torch.zeros_like(w))
    return JT * wv[..., None, :], r * wv, fields.valid


def _eager_sfm_step_batch(poses0, poses1, cam, img0s, img1s, dpt0s, jacs0,
                          grad1s, params, chunk_bytes, loss):
    P = img0s.shape[0]
    CS = jacs0.shape[-1]
    N = H * W
    pose_10, j_pose1, j_pose0 = se3m.relative_pose_jacobians(poses1, poses0)
    wparams = dw.make_warp_params(pose_10, cam, params.valid_border,
                                  params.min_dpt)
    grid = ds._pixel_grid(H, W, img0s.device).reshape(-1, 2)
    u = (grid[:, 0] - cam.u0) / cam.fx
    v = (grid[:, 1] - cam.v0) / cam.fy
    chunk = max(1, chunk_bytes // ((12 + CS) * N * 4))
    out = []
    for a in range(0, P, chunk):
        c = slice(a, a + chunk)
        dpt = dpt0s[c].contiguous()
        warp = dw.dense_warp_batch(
            wparams[c], dpt, img1s[c].contiguous(),
            grad1s[c, ..., 0].contiguous(), grad1s[c, ..., 1].contiguous())
        Jw, rw, valid = _eager_chunk(cam, se3m.index(pose_10, c), j_pose0[c],
                                     j_pose1[c], u, v, warp, dpt, img0s[c],
                                     jacs0[c], params, loss)
        out.append(ds.SystemResult(Jw @ Jw.transpose(-1, -2),
                                   (Jw @ rw[..., None])[..., 0],
                                   torch.sum(rw * rw, dim=-1),
                                   torch.sum(valid.to(torch.float32), dim=-1)))
    return ds.SystemResult(*(torch.cat(x) for x in zip(*out)))


# ----------------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------------

def _camera():
    return PinholeCamera.create(fx=30.0, fy=31.0, u0=W / 2 - 0.5,
                                v0=H / 2 + 0.25, width=W, height=H)


def _problem(P, CS, seed):
    """P factors of smooth images with perturbed poses: most pixels valid,
    some warped outside the border, and in factor 0 a band of pixels
    behind the camera (invalid) next to one at tptz ~ 0."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img0 = np.stack([0.5 + 0.3 * np.sin(xs / 5 + k) * np.cos(ys / 4 + 0.2 * k)
                     for k in range(P)]).astype(np.float32)
    img1 = np.stack([0.5 + 0.3 * np.sin(xs / 5 + k + 0.1) * np.cos(ys / 4)
                     + 0.05 * rng.rand(H, W) for k in range(P)])
    grad1 = np.stack([np.stack(np.gradient(im)[::-1], axis=-1)
                      for im in img1]).astype(np.float32)
    dpt = (1.0 + rng.rand(P, H, W)).astype(np.float32)
    jac = (0.02 * rng.standard_normal((P, H, W, CS))).astype(np.float32)

    def poses(scale):
        w = scale * rng.standard_normal((P, 3))
        q = np.concatenate([np.ones((P, 1)), w / 2], axis=1)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t = 3 * scale * rng.standard_normal((P, 3))
        return SE3(torch.tensor(q, dtype=torch.float32),
                   torch.tensor(t, dtype=torch.float32))

    p0, p1 = poses(0.05), poses(0.05)
    # factor 0: pose1 = pose0 moved 0.5 m along its optical axis, so that
    # depths at 0.5 come out at tptz ~ 0 and below it behind the camera
    R0 = se3m.quat_to_matrix(p0.q[0])
    p1.q[0] = p0.q[0]
    p1.t[0] = p0.t[0] + 0.5 * R0[:, 2]
    dpt[0, :3] = 0.2
    dpt[0, 3] = 0.5
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return p0, p1, T(img0), T(img1), T(dpt), T(jac), T(grad1)


def _params():
    return ds.SfmParams(huber_delta=0.1, avg_dpt=2.0, min_dpt=MIN_DPT,
                        valid_border=BORDER)


def _bits(x):
    return x.contiguous().view(torch.int32)


# ----------------------------------------------------------------------------
# tests
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("CS", [8, 32])
@pytest.mark.parametrize("loss", ["huber", "tukey"])
def test_plain_twin_equals_the_eager_chain(CS, loss):
    """Jw and rw of the twin, bit for bit, NaN where the eager chain's is:
    rows that are not finite where the weight is 0."""
    P = 5
    p0, p1, img0, img1, dpt, jac, grad1 = _problem(P, CS, seed=CS)
    cam, params = _camera(), _params()
    pose_10, j_pose1, j_pose0 = se3m.relative_pose_jacobians(p1, p0)
    wparams = dw.make_warp_params(pose_10, cam, BORDER, MIN_DPT)
    warp = list(dw.dense_warp_batch(wparams, dpt, img1,
                                    grad1[..., 0].contiguous(),
                                    grad1[..., 1].contiguous()))
    # where tptz is ~0 (depth 0.5 in factor 0), make it 0: inf in A
    warp[5] = torch.where(warp[5].abs() < 1e-5, torch.zeros_like(warp[5]),
                          warp[5])
    grid = ds._pixel_grid(H, W, dpt.device).reshape(-1, 2)
    u = (grid[:, 0] - cam.u0) / cam.fx
    v = (grid[:, 1] - cam.v0) / cam.fy
    Jw, rw = js.jacobian_stack(wparams, warp, dpt, img0, jac, j_pose0,
                               j_pose1, u, v, params.huber_delta,
                               params.avg_dpt, loss)
    Je, re, valid = _eager_chunk(cam, pose_10, j_pose0, j_pose1, u, v, warp,
                                 dpt, img0, jac, params, loss)
    assert Jw.shape == (P, 12 + CS, H * W) and Jw.is_contiguous()
    assert torch.equal(_bits(Jw), _bits(Je))
    assert torch.equal(_bits(rw), _bits(re))
    # the inputs reach what they are meant to: invalid pixels behind the
    # camera and outside the border, tptz ~ 0, NaN rows at weight 0
    tptz = warp[5].reshape(P, -1)
    assert 0.3 < float(valid.float().mean()) < 0.95
    assert bool((tptz[0] < 0).any())
    assert bool((~valid[1:]).any())
    assert bool((tptz[0] == 0).any()) and bool((tptz[1:] != 0).all())
    assert bool(torch.isnan(Jw[0]).any()) and bool(torch.isfinite(Jw[1:]).all())
    rows = Jw.transpose(1, 2)[1:]                 # [P - 1, N, 12 + CS]
    assert bool((rows[~valid[1:]] == 0).all())
    if loss == "huber":
        assert bool((rows[valid[1:]] != 0).any(dim=-1).all())
    else:
        assert bool(((rw == 0) & valid).any())      # redescended to 0


@pytest.mark.parametrize("chunk_bytes", [1 << 30, 3 * (12 + 32) * H * W * 4])
@pytest.mark.parametrize("CS", [8, 32])
@pytest.mark.parametrize("loss", ["huber", "tukey"])
def test_sfm_step_batch_equals_the_eager_chain(monkeypatch, chunk_bytes, CS,
                                               loss):
    """The systems of ``sfm_step_batch`` bit for bit against the eager
    chain's, every factor in one chunk and in chunks of three (at CS 32;
    of six at CS 8), the last one short."""
    P = 7
    monkeypatch.setattr(ds, "_JT_CHUNK_BYTES", chunk_bytes)
    p0, p1, img0, img1, dpt, jac, grad1 = _problem(P, CS, seed=10 + CS)
    dpt[0, :4] = 1.0           # no tptz ~ 0: every system finite
    cam, params = _camera(), _params()
    codes = torch.zeros((P, CS))
    out = ds.sfm_step_batch(p0, p1, codes, cam, img0, img1, dpt, img0, jac,
                            grad1, params, grad_mode="sampled", loss=loss)
    ref = _eager_sfm_step_batch(p0, p1, cam, img0, img1, dpt, jac, grad1,
                                params, chunk_bytes, loss)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all()
        assert torch.equal(_bits(a), _bits(b))
    assert bool((out.inliers > 0).all())
    assert bool((out.inliers < H * W).any())


def _args(P=3, CS=8):
    p0, p1, img0, img1, dpt, jac, grad1 = _problem(P, CS, seed=3)
    cam = _camera()
    pose_10, j_pose1, j_pose0 = se3m.relative_pose_jacobians(p1, p0)
    wparams = dw.make_warp_params(pose_10, cam, BORDER, MIN_DPT)
    warp = tuple(x.contiguous() for x in dw.dense_warp_batch(
        wparams, dpt, img1, grad1[..., 0].contiguous(),
        grad1[..., 1].contiguous()))
    u = torch.zeros(H * W)
    return dict(params=wparams, warp=warp, dpt0=dpt, img0=img0, jac0=jac,
                j_pose0=j_pose0.contiguous(), j_pose1=j_pose1.contiguous(),
                u=u, v=u.clone())


@pytest.mark.parametrize("name,bad,err", [
    ("dpt0", lambda a: a.double(), TypeError),
    ("img0", lambda a: a[:, :, :-1], ValueError),
    ("jac0", lambda a: a[..., :4], ValueError),
    ("jac0", lambda a: a.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
     ValueError),
    ("j_pose0", lambda a: a.transpose(-1, -2), ValueError),
    ("params", lambda a: a[:, :18], ValueError),
    ("u", lambda a: a[:-1], ValueError),
    ("warp", lambda a: a[:6], ValueError),
    ("warp", lambda a: a[:3] + (a[3].half(),) + a[4:], TypeError),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(name, bad, err):
    """The CUDA route checks dtype, shape and contiguity before it builds or
    launches anything (checked here on CPU tensors)."""
    kw = _args()
    kw[name] = bad(kw[name])
    with pytest.raises(err):
        js._jacobian_stack_cuda(huber_delta=0.1, avg_dpt=2.0, loss="huber",
                                **kw)
    with pytest.raises(ValueError, match="loss"):
        js._jacobian_stack_cuda(huber_delta=0.1, avg_dpt=2.0, loss="cauchy",
                                **_args())


@pytest.mark.parametrize("CS,stride", [(8, 9), (32, 33), (5, 5), (64, 65)])
def test_launch_plan(CS, stride):
    """One pixel a thread, a block a strip of 256 pixels of one factor; the
    code Jacobian's tile rows an odd number of floats apart."""
    plan = sg.launch_plan("jacobian_stack", 124, 192, 256, CS)
    assert plan.grid == (192, 124) and plan.px_per_blk == sg.THREADS
    assert plan.nblk == 192 and plan.stride == stride
    assert plan.smem_bytes == 4 * sg.THREADS * stride <= sg._SMEM_MAX
    assert sg.launch_plan("jacobian_stack", 3, 13, 21, CS).nblk == 2
    with pytest.raises(ValueError):
        sg.launch_plan("jacobian_stack", 3, 13, 21, 65)


def test_f32_reciprocal_rounds_in_float32():
    assert js._f32_reciprocal(0.1) == float(np.float32(1) / np.float32(0.1))
    assert js._f32_reciprocal(0.3) != 1 / 0.3


def test_cpu_tensors_never_launch_the_kernel():
    js.reset_launch_counts()
    kw = _args()
    Jw, rw = js.jacobian_stack(huber_delta=0.1, avg_dpt=2.0, **kw)
    assert Jw.shape == (3, 20, H * W) and rw.shape == (3, H * W)
    assert js.LAUNCHES == {"jacobian_stack": 0}
