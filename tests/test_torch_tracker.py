"""deepfactors_tpu_torch.tracking.tracker against the JAX package: the same
keyframe (rendered room view with its depth) and the same live frame go
through ``track_c2f`` / ``CameraTracker`` in both packages.

Tolerance: poses within 1e-4 (both run the same fixed GN schedule in fp32;
the Gram sums differ in order), inlier fraction exact, finest-level error
within 1e-4 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.geometry import camera as jcm
from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu.tracking import tracker as jtr
from deepfactors_tpu_torch.geometry import camera as tcm
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.ops import image as tip
from deepfactors_tpu_torch.ops.kernels import sfm_gram as tsg
from deepfactors_tpu_torch.tracking import tracker as ttr

torch.set_num_threads(2)
H, W, L = 48, 64, 2
TOL = 1e-4


@pytest.fixture(scope="module")
def views():
    kw = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)
    cam = jcm.PinholeCamera.create(**kw)
    img0, dpt0 = (np.array(a) for a in jsynth.render_aa(scene, cam, poses[0], H, W))
    img1, _ = (np.array(a) for a in jsynth.render_aa(scene, cam, poses[2], H, W))
    # start from the true relative pose perturbed, as the constant-velocity
    # prediction would
    true_ck = jse3.mul(jse3.inverse(poses[2]), poses[0])
    init = jse3.retract(true_ck, jnp.asarray([0.01, -0.01, 0.02, 0.01, 0.01, -0.01],
                                             jnp.float32))
    return dict(kw=kw, img0=img0, dpt0=dpt0, img1=img1,
                q=np.array(init.q), t=np.array(init.t), true_ck=true_ck)


def _both(v, grad_mode):
    cfg = dict(pyramid_levels=L, iterations_per_level=(10, 5), huber_delta=0.3,
               grad_mode=grad_mode)
    # JAX
    jc = jcm.camera_pyramid(jcm.PinholeCamera.create(**v["kw"]), L)
    jk = jip.build_pyramid(jnp.asarray(v["img0"]), L)
    jd = jip.build_pyramid(jnp.asarray(v["dpt0"]), L)
    ji = jip.build_pyramid(jnp.asarray(v["img1"]), L)
    jg = jip.build_gradient_pyramid(ji)
    qj, tj, sj = jtr.track_c2f(jtr.TrackerConfig(**cfg), jc,
                               jse3.SE3(jnp.asarray(v["q"]), jnp.asarray(v["t"])),
                               tuple(jk), tuple(jd), tuple(ji), tuple(jg))
    # port
    T = torch.from_numpy
    tc = tcm.camera_pyramid(tcm.PinholeCamera.create(**v["kw"]), L)
    tk = tip.build_pyramid(T(v["img0"]), L)
    td = tip.build_pyramid(T(v["dpt0"]), L)
    ti = tip.build_pyramid(T(v["img1"]), L)
    tg = tip.build_gradient_pyramid(ti)
    qt, tt, st = ttr.track_c2f(ttr.TrackerConfig(**cfg), tc,
                               tse3.SE3(T(v["q"]), T(v["t"])),
                               tuple(tk), tuple(td), tuple(ti), tuple(tg))
    return (np.asarray(qj), np.asarray(tj), np.asarray(sj)), \
        (qt.numpy(), tt.numpy(), st.numpy())


@pytest.mark.parametrize("grad_mode", ["interp", "sampled"])
def test_track_c2f_matches_jax(views, grad_mode):
    (qj, tj, sj), (qt, tt, st) = _both(views, grad_mode)
    np.testing.assert_allclose(qt, qj, atol=TOL)
    np.testing.assert_allclose(tt, tj, atol=TOL)
    assert st[0] == sj[0]                      # inlier fraction
    np.testing.assert_allclose(st[1], sj[1], rtol=TOL)
    # and both actually tracked: the estimate is near the true motion
    err = np.asarray(jse3.local(views["true_ck"], jse3.SE3(jnp.asarray(qt),
                                                           jnp.asarray(tt))))
    assert np.linalg.norm(err) < 2e-2
    assert tsg.LAUNCHES["se3_gram_batch"] == 0


def test_camera_tracker_facade_matches_jax(views):
    v = views
    kw = dict(pyramid_levels=L, iterations_per_level=(10, 5), huber_delta=0.3)
    T = torch.from_numpy
    jt = jtr.CameraTracker(jtr.TrackerConfig(**kw), jcm.PinholeCamera.create(**v["kw"]))
    tt = ttr.CameraTracker(ttr.TrackerConfig(**kw), tcm.PinholeCamera.create(**v["kw"]),
                           device="cpu")
    pose_wk = (np.array([0.99, 0.0, 0.141, 0.0], np.float32), np.array([0.1, 0.0, -0.2], np.float32))
    pose_wk = (pose_wk[0] / np.linalg.norm(pose_wk[0]), pose_wk[1])
    jt.set_keyframe(jip.build_pyramid(jnp.asarray(v["img0"]), L),
                    jip.build_pyramid(jnp.asarray(v["dpt0"]), L),
                    jse3.SE3(jnp.asarray(pose_wk[0]), jnp.asarray(pose_wk[1])))
    tt.set_keyframe(tip.build_pyramid(T(v["img0"]), L), tip.build_pyramid(T(v["dpt0"]), L),
                    tse3.SE3(T(pose_wk[0]), T(pose_wk[1])))
    jt.pose_ck = jse3.SE3(jnp.asarray(v["q"]), jnp.asarray(v["t"]))
    tt.pose_ck = tse3.SE3(T(v["q"]), T(v["t"]))
    ji = jip.build_pyramid(jnp.asarray(v["img1"]), L)
    ti = tip.build_pyramid(T(v["img1"]), L)
    rj = jt.track_frame(ji, jip.build_gradient_pyramid(ji))
    rt = tt.track_frame(ti, tip.build_gradient_pyramid(ti))
    assert float(rt.inliers) == float(rj.inliers)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=TOL)
    pj, pt = jt.get_pose_estimate(), tt.get_pose_estimate()
    np.testing.assert_allclose(pt.q.numpy(), np.asarray(pj.q), atol=TOL)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=TOL)
