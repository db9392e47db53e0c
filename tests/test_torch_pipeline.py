"""The pipelined facade of deepfactors_tpu_torch (pipeline_depth >= 1) and
the facade entry points around it, on the CPU.

1. Ports of tests/test_pipeline.py's three tests, on the port alone (its
   own synthetic room, oracle decoder and random vocabulary), with the
   same assertions: depth 1 over 40 frames against the sequential run of
   the same scene (every frame tracked, the pipeline drained by ``flush``,
   the trajectory full, the ATE in the sequential run's class, the window
   evicting), depth 2 over 60 frames, ``flush`` idempotent in sequential
   mode. tests/test_torch_pipeline_pair.py holds the port's decisions to
   the JAX facade's.
2. ``_host_pose_distance`` (float64 numpy on both sides) equals the JAX
   package's bit for bit over 100 seeded pose pairs.
3. ``CameraTracker.track_burst`` against the JAX tracker's ``lax.scan``
   burst at N = 4: poses and stats within 1e-5.
4. ``prewarm`` in the middle of a pipelined run (loop closure and
   reprojection factors on, the model decoder): every tensor of the map
   state, frame store, marginal store and loop detector, and the RANSAC
   generator, bitwise as before; the run that goes on equals, bit for bit,
   the same run without the prewarm."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params

from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu.system import _host_pose_distance as j_host_distance
from deepfactors_tpu.tracking.tracker import CameraTracker as JTracker
from deepfactors_tpu.tracking.tracker import TrackerConfig as JTC
from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.geometry.se3 import SE3
from deepfactors_tpu_torch.io import synth
from deepfactors_tpu_torch.loop.vocabulary import random_vocabulary
from deepfactors_tpu_torch.mapping.mapper import MapperConfig
from deepfactors_tpu_torch.models.decoder import Decoder, NetworkConfig
from deepfactors_tpu_torch.ops import image as tip
from deepfactors_tpu_torch.system import DeepFactors, SystemConfig
from deepfactors_tpu_torch.system import _host_pose_distance
from deepfactors_tpu_torch.tracking.tracker import CameraTracker, TrackerConfig
from deepfactors_tpu_torch.utils import tum_io

torch.set_num_threads(2)
H, W = 48, 64
BURST_TOL = 1e-5
CAM = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)


def _scene(n=40):
    cam = PinholeCamera.create(**CAM)
    scene = synth.random_room(11, n_boxes=2, freq_scale=0.3)
    poses = synth.orbit_trajectory(n, radius=0.5, sweep=1.2 * np.pi)
    frames, depths = synth.render_sequence(scene, cam, poses, H, W,
                                           with_depth=True, device="cpu")
    oracle = synth.OracleDecoder(frames, depths, levels=2, code_size=4)
    return cam, poses, frames, oracle, n


def _run(cam, poses, frames, oracle, n, depth):
    cfg = SystemConfig(
        mapper=MapperConfig(
            max_keyframes=4, max_frames=1, max_factors=16, code_size=4,
            height=H, width=W, pyramid_levels=2, pho_iters=(4, 6),
            connection_mode="LASTN", max_back_connections=2,
            use_schur=False),
        dist_threshold=0.6, frame_dist_threshold=0.5, loop_closure=True,
        loop_active_window=3, loop_max_dist=0.3, pipeline_depth=depth)
    df = DeepFactors(cfg, cam, decoder=oracle,
                     vocabulary=random_vocabulary(64, device="cpu"),
                     device="cpu")
    df.bootstrap_two_frames(frames[0], frames[1])
    df.trajectory = [(0.0, df.pose_wc)]
    for i in range(2, n):
        df.process_frame(float(i), frames[i])
    df.flush()
    return df


def _ate(df, poses):
    est = df.trajectory
    return tum_io.ate_rmse(est, [(ts, poses[int(ts)]) for ts, _ in est])


@pytest.fixture(scope="module")
def scene40():
    return _scene()


def test_pipelined_matches_sequential(scene40):
    cam, poses, frames, oracle, n = scene40
    seq = _run(cam, poses, frames, oracle, n, depth=0)
    pipe = _run(cam, poses, frames, oracle, n, depth=1)
    assert not pipe.tracking_lost
    assert len(pipe._pending) == 0          # flush drained the pipeline
    assert pipe.n_frames == seq.n_frames == n - 2
    assert pipe.n_lost_frames == 0
    assert len(pipe.trajectory) == n - 1
    a_seq, a_pipe = _ate(seq, poses), _ate(pipe, poses)
    assert np.isfinite(a_pipe), a_pipe
    assert a_pipe < max(2.0 * a_seq, 0.15), (a_seq, a_pipe)
    assert len(pipe.mapper.kf_slots) <= 4
    assert len(pipe.mapper.kf_slots) + len(pipe.mapper.archived) > 4


def test_pipelined_depth2_runs():
    cam, poses, frames, oracle, n = _scene(n=60)
    pipe = _run(cam, poses, frames, oracle, n, depth=2)
    assert not pipe.tracking_lost
    assert len(pipe._pending) == 0
    ate = _ate(pipe, poses)
    assert np.isfinite(ate) and ate < 0.2, ate


def test_flush_idempotent_sequential(scene40):
    cam, poses, frames, oracle, n = scene40
    seq = _run(cam, poses, frames, oracle, n, depth=0)
    seq.flush()   # no-op in sequential mode
    assert len(seq.trajectory) == n - 1


def test_host_pose_distance_bit_equal():
    rng = np.random.RandomState(0)
    for _ in range(100):
        q = rng.randn(2, 4)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        q = q.astype(np.float32)
        t = rng.uniform(-2, 2, (2, 3)).astype(np.float32)
        a, b = SE3(q[0], t[0]), SE3(q[1], t[1])
        got = _host_pose_distance(a, b)
        want = j_host_distance(JSE3(q[0], t[0]), JSE3(q[1], t[1]))
        assert got == want and type(got) is float


def test_track_burst_matches_jax():
    n = 5
    scene = jsynth.random_room(3, n_boxes=3)
    poses = jsynth.orbit_trajectory(60, radius=0.5, sweep=0.8 * np.pi)[:n]
    frames, depths = jsynth.render_sequence(scene, JCam.create(**CAM), poses,
                                            H, W, with_depth=True)
    frames = [np.array(f) for f in frames]
    L, iters = 2, (6, 4)
    jt = JTracker(JTC(pyramid_levels=L, iterations_per_level=iters,
                      huber_delta=0.3), JCam.create(**CAM))
    tt = CameraTracker(TrackerConfig(pyramid_levels=L,
                                     iterations_per_level=iters,
                                     huber_delta=0.3),
                       PinholeCamera.create(**CAM), device="cpu")
    ident_q = np.array([1.0, 0, 0, 0], np.float32)
    jt.set_keyframe(jip.build_pyramid(jnp.asarray(frames[0]), L),
                    jip.build_pyramid(jnp.asarray(np.array(depths[0])), L),
                    JSE3(jnp.asarray(ident_q), jnp.zeros(3)))
    tt.set_keyframe(tip.build_pyramid(torch.as_tensor(frames[0]), L),
                    tip.build_pyramid(torch.as_tensor(np.array(depths[0])), L),
                    SE3(torch.as_tensor(ident_q), torch.zeros(3)))
    # per-frame pyramids, stacked per level
    jp = [jip.build_pyramid(jnp.asarray(f), L) for f in frames[1:]]
    tp = [tip.build_pyramid(torch.as_tensor(f), L) for f in frames[1:]]
    jg = [jip.build_gradient_pyramid(p) for p in jp]
    tg = [tip.build_gradient_pyramid(p) for p in tp]
    stack_j = lambda ps: tuple(jnp.stack(lv) for lv in zip(*ps))
    stack_t = lambda ps: tuple(torch.stack(lv) for lv in zip(*ps))
    jq, jtr, jst = jt.track_burst(stack_j(jp), stack_j(jg))
    tq, ttr, tst = tt.track_burst(stack_t(tp), stack_t(tg))
    assert tq.shape == (n - 1, 4) and ttr.shape == (n - 1, 3)
    assert tst.shape == (n - 1, 2)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=BURST_TOL)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), atol=BURST_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=BURST_TOL)
    # the tracker holds the last frame's pose, as the JAX tracker does
    np.testing.assert_allclose(tt.pose_ck.t.numpy(), np.asarray(jt.pose_ck.t),
                               atol=BURST_TOL)
    # the frames move: each tracked pose differs from the last
    assert np.all(np.linalg.norm(np.diff(ttr.numpy(), axis=0), axis=-1) > 1e-3)


def _snapshot(df) -> dict:
    """Every tensor of the map state, frame store, marginal store and loop
    detector, and the RANSAC generator's state, as host copies."""
    out = {}

    def walk(prefix, x):
        if torch.is_tensor(x):
            out[prefix] = x.detach().clone()
        elif isinstance(x, tuple):
            names = getattr(x, "_fields", range(len(x)))
            for name, v in zip(names, x):
                walk(f"{prefix}.{name}", v)

    m, ld = df.mapper, df.loop_detector
    walk("state", m.state)
    walk("frames", m.frames)
    walk("marginals", m.marginals)
    for k in ("db", "db_valid", "arch_img", "arch_dpt", "arch_q", "arch_t"):
        out["loop." + k] = getattr(ld, k).clone()
    out["loop.arch_ids"] = torch.as_tensor(ld.arch_ids.copy())
    out["rng"] = m._rng.get_state()
    return out


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and torch.equal(
            a[k].view(torch.uint8) if a[k].dtype == torch.bool else a[k],
            b[k].view(torch.uint8) if b[k].dtype == torch.bool else b[k]), k


def _prewarm_run(prewarm: bool):
    """A pipelined run with loop closure and reprojection factors on and a
    random-init model decoder, on the room orbit; with ``prewarm`` the
    facade is prewarmed after frame 6, with a frame in flight."""
    ncfg = dict(code_size=4, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    dec = Decoder(NetworkConfig(**ncfg),
                  params=random_decoder_params(JNC(**ncfg), seed=0),
                  device="cpu")
    cam = PinholeCamera.create(**CAM)
    scene = synth.random_room(7, n_boxes=3)
    poses = synth.orbit_trajectory(80, sweep=3.2 * np.pi)[:15]
    frames = synth.render_sequence(scene, cam, poses, H, W, device="cpu")
    cfg = SystemConfig(
        mapper=MapperConfig(max_keyframes=4, max_frames=2, max_factors=16,
                            code_size=4, height=H, width=W, pyramid_levels=2,
                            pho_iters=(4, 8), max_back_connections=2,
                            max_keypoints=64),
        tracking_iterations=(10, 5), dist_threshold=2.0,
        tracking_dist_threshold=5.0, frame_dist_threshold=0.12,
        loop_closure=True, loop_active_window=2, loop_archive_cap=4,
        pipeline_depth=1)
    df = DeepFactors(cfg, cam, decoder=dec,
                     vocabulary=random_vocabulary(64, device="cpu"),
                     device="cpu")
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    df.trajectory = [(0.0, df.pose_wc)]
    snaps = None
    for i in range(3, len(frames)):
        df.process_frame(float(i), frames[i])
        if i == 6 and prewarm:
            before = _snapshot(df)
            pending = len(df._pending)
            df.prewarm()
            snaps = (before, _snapshot(df))
            assert len(df._pending) == pending
    df.flush()
    return df, snaps


def test_prewarm_state_neutral_and_run_identical():
    warm, (before, after) = _prewarm_run(prewarm=True)
    cold, _ = _prewarm_run(prewarm=False)
    _assert_bitwise(before, after)
    assert cold.mapper._next_kid >= 4 and cold.n_evictions >= 1
    assert warm.n_lost_frames == cold.n_lost_frames == 0
    assert [ts for ts, _ in warm.trajectory] == \
        [ts for ts, _ in cold.trajectory]
    for (_, a), (_, b) in zip(warm.trajectory, cold.trajectory):
        assert np.array_equal(a.q, b.q) and np.array_equal(a.t, b.t)
    assert warm.mapper.kf_slots == cold.mapper.kf_slots
    _assert_bitwise(_snapshot(warm), _snapshot(cold))
