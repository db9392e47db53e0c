"""deepfactors_tpu_torch.mapping.mapper against the JAX Mapper on the same
fixed window: a 48x64, 2-level room sequence rendered by the JAX package,
a small random-init decoder carried across by ``params_from_jax``.

Stages, run identically in both packages:
  1. ``init_two_frames`` on frames 0 and 2 (bootstrap alignment + BA until
     the work queue drains);
  2. a one-way frame (frame 3) enqueued against the second keyframe, mapped
     until no work is left;
  3. a third keyframe (frame 4) enqueued, which marginalises the frame into
     a prior on its keyframe, then one ``mapping_run`` (the coarse-to-fine
     ``run_segments`` descent).

Tolerance. Both packages decode in bf16 with rounding in different places
(see test_torch_decoder.py): the decoded depth of a keyframe differs by
~1.5e-4 of its value before any optimisation, and the window's poses (of
order 0.4 m) inherit that. So keyframe poses and codes are held within 5e-4
after each stage (codes in their own units, where the zero-code prior has
sigma 1), the last stage's pose and code deltas within 1e-2 of the largest
delta (they reach ~0.1 m; the measured gap is ~2e-3 of it), and the
marginal prior within 1e-3 relative."""
import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.mapping.mapper import Mapper as JMapper
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.models.decoder import Decoder as JDec
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping.mapper import Mapper as TMapper
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.models.decoder import Decoder as TDec
from deepfactors_tpu_torch.models.decoder import NetworkConfig as TNC
from deepfactors_tpu_torch.ops.kernels import sfm_gram as tsg

torch.set_num_threads(2)
H, W, CS = 48, 64, 4
TOL = 5e-4
DELTA_TOL = 1e-2


def _snap(m):
    p = m.keyframe_poses()
    return dict(q=np.array(p.q), t=np.array(p.t), c=np.array(m.keyframe_codes()),
                slots=list(m.kf_slots))


def _drive(m, SE, frames, rel):
    pose = lambda i: SE(np.array(rel[i].q, np.float32),
                        np.array(rel[i].t, np.float32))
    out = {}
    s0, s1 = m.init_two_frames(frames[0], frames[2])
    m.update_map()
    out["init"] = _snap(m)
    m.enqueue_frame(frames[3], pose(3), s1)
    while m.has_work():
        m.mapping_run()
    m.update_map()
    out["frame"] = _snap(m)
    # the third keyframe starts 2 cm off its true position, so the descent
    # has real work to do
    p4 = pose(4)
    m.enqueue_keyframe(frames[4], SE(p4.q, p4.t + np.array([0.02, -0.01, 0.01], np.float32)))
    mg = m.marginals
    out["marg"] = dict(active=np.array(mg.active), q=np.array(mg.anchor_q),
                       t=np.array(mg.anchor_t), c=np.array(mg.anchor_c))
    out["pre"] = _snap(m)
    m.mapping_run()
    out["run"] = _snap(m)
    return out


@pytest.fixture(scope="module")
def runs():
    kw = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)[:6]
    frames = [np.array(f) for f in
              jsynth.render_sequence(scene, JCam.create(**kw), poses, H, W)]
    # the map is anchored at the first keyframe (identity): hand both
    # mappers the true poses relative to frame 0
    rel = [jse3.mul(jse3.inverse(poses[0]), p) for p in poses]
    ncfg = dict(code_size=CS, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    jdec = JDec(JNC(**ncfg), params=params)
    tdec = TDec(TNC(**ncfg), params=params, device="cpu")
    mk = lambda MC: MC(max_keyframes=4, max_frames=2, max_factors=16, code_size=CS,
                       height=H, width=W, pyramid_levels=2, pho_iters=(4, 8),
                       max_back_connections=2, use_reprojection=False)
    tsg.reset_launch_counts()
    return dict(
        jax=_drive(JMapper(mk(JMC), JCam.create(**kw), decoder=jdec), JSE3, frames, rel),
        torch=_drive(TMapper(mk(TMC), TCam.create(**kw), decoder=tdec, device="cpu"),
                     TSE3, frames, rel))


def _close_state(a, b):
    assert a["slots"] == b["slots"]
    np.testing.assert_allclose(a["q"], b["q"], atol=TOL)
    np.testing.assert_allclose(a["t"], b["t"], atol=TOL)
    np.testing.assert_allclose(a["c"], b["c"], atol=TOL)


@pytest.mark.parametrize("stage", ["init", "frame", "run"])
def test_states_match_jax(runs, stage):
    _close_state(runs["torch"][stage], runs["jax"][stage])


def test_run_segments_deltas_match_jax(runs):
    a0, a1 = runs["torch"]["pre"], runs["torch"]["run"]
    b0, b1 = runs["jax"]["pre"], runs["jax"]["run"]
    for k in ("t", "c"):
        da, db = a1[k] - a0[k], b1[k] - b0[k]
        assert np.max(np.abs(db)) > 0
        assert np.max(np.abs(da - db)) <= DELTA_TOL * np.max(np.abs(db))


def test_frame_marginal_prior_matches_jax(runs):
    """The frame is folded into a prior on the same keyframe, anchored at
    the same (pose, code). Its (H, b) are not compared here: one
    keyframe-frame factor holds no information on the keyframe pose once the
    frame pose is eliminated, so H is a difference of O(1e3) terms that
    cancel to O(1e-3), i.e. f32 round-off; test_schur_marginal_matches_jax
    holds the arithmetic on a well-posed system."""
    a, b = runs["torch"]["marg"], runs["jax"]["marg"]
    np.testing.assert_array_equal(a["active"], b["active"])
    assert a["active"].sum() == 1
    for k in ("q", "t", "c"):
        np.testing.assert_allclose(a[k], b[k], atol=TOL)


def test_schur_marginal_matches_jax():
    """schur_marginalize_frame, add_prior (twice, so the second re-anchors
    the first) and prior_terms on a seeded system with coupled blocks.
    Tolerance 1e-4 of the largest |entry|: one 6x6 inverse and two fp32
    matrix products in a different summation order."""
    from deepfactors_tpu.mapping import marginal as jmg
    from deepfactors_tpu_torch.mapping import marginal as tmg

    rng = np.random.RandomState(5)
    D = 12 + CS
    J = rng.randn(3 * D, D).astype(np.float32)
    JtJ = (J.T @ J).astype(np.float32)
    Jtr = rng.randn(D).astype(np.float32)
    Hj, bj = jmg.schur_marginalize_frame(JtJ, Jtr, CS)
    Ht, bt = tmg.schur_marginalize_frame(torch.from_numpy(JtJ),
                                         torch.from_numpy(Jtr), CS)
    scale = np.abs(np.asarray(Hj)).max()
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-4 * scale)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj),
                               atol=1e-4 * np.abs(np.asarray(bj)).max())

    K = 3
    poses = [(rng.randn(K, 4), 0.1 * rng.randn(K, 3)) for _ in range(2)]
    poses = [((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
              t.astype(np.float32)) for q, t in poses]
    codes = [0.1 * rng.randn(K, CS).astype(np.float32) for _ in range(2)]
    js, ts = jmg.create(K, CS), tmg.create(K, CS, device="cpu")
    for (q, t), c in zip(poses, codes):
        js = jmg.add_prior(js, 1, Hj, bj, JSE3(q[1], t[1]), c[1])
        ts = tmg.add_prior(ts, 1, Ht, bt, TSE3(torch.from_numpy(q[1]),
                                               torch.from_numpy(t[1])),
                           torch.from_numpy(c[1]))
    q, t = poses[0]
    Hp_j, g_j = jmg.prior_terms(js, JSE3(q, t), codes[0])
    Hp_t, g_t = tmg.prior_terms(ts, TSE3(torch.from_numpy(q), torch.from_numpy(t)),
                                torch.from_numpy(codes[0]))
    np.testing.assert_allclose(Hp_t.numpy(), np.asarray(Hp_j), atol=1e-4 * 2 * scale)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                               atol=1e-4 * np.abs(np.asarray(g_j)).max())


def test_cpu_mapper_never_launches_a_kernel(runs):
    assert tsg.LAUNCHES == {"se3_gram_batch": 0, "sfm_gram_batch": 0}
