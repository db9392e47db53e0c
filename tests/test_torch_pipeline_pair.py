"""The pipelined facade of deepfactors_tpu_torch against the JAX facade,
decision for decision, on the CPU.

The scene of tests/test_pipeline.py's depth-2 test: 48x64, 2 levels, the
60-frame orbit of random_room(11) (rendered by the JAX package), the ground-truth
``OracleDecoder`` of each package, loop closure on with JAX's
``random_vocabulary(64)`` carried across (``vocabulary_from_numpy``),
reprojection factors on with the port's RANSAC draws replaying the JAX
mapper's key chain (``JaxKeyChain``), a window of 4 keyframes (the run
evicts), ``pipeline_depth=1``. Before frame FORCE_KF the caller forces a
keyframe, in both packages. The run builds a keyframe at about every
other retire and the retire after an event is stale, so the stale rule,
the distance clamp and the lookahead all act (at the 40-frame orbit's
pacing no frame-to-frame distance rate is ever measured: each step
exceeds the threshold that rejects divergence).

What must agree, frame for frame (one record per retired frame):
  - the frame's number, the keyframe it was tracked against, its stale
    flag, and the decisions it drove (lost, keyframe built, one-way frame
    enqueued): identical;
  - the keyframe-distance rate ``_d_rate`` after the frame: within 1e-5;
  - ``n_lost_frames``, ``n_frames``, ``len(trajectory)``: identical, and
    every frame retired after ``flush``;
  - the tracked poses: within POSE_T_TOL / POSE_Q_TOL of
    tests/test_torch_system.py;
  - the callbacks: each called as often in both.
A second pair bootstraps on one frame (``bootstrap_one_frame``) and tracks
three frames sequentially, a one-way frame forced before the second:
poses within 1e-5; the keyframe events and the forced frame (enqueued by
the first frame after the flag that builds no keyframe) the same in
both. A third pair runs the first UPLOAD_FRAMES frames at depth 1 with
the frames uploaded as uint8 and as float16 (``frame_upload``): the
decisions identical and the poses within POSE_T_TOL / POSE_Q_TOL."""
import numpy as np
import pytest
import torch
from test_torch_mapper_rep import JaxKeyChain
from test_torch_system import POSE_Q_TOL, POSE_T_TOL

from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.loop import vocabulary as jvb
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.system import DeepFactors as JDF
from deepfactors_tpu.system import SystemConfig as JSC
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.io import synth as tsynth
from deepfactors_tpu_torch.loop import vocabulary as tvb
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.system import DeepFactors as TDF
from deepfactors_tpu_torch.system import SystemConfig as TSC

torch.set_num_threads(2)
H, W, N = 48, 64, 60
FORCE_KF = 20
RATE_TOL = 1e-5
ONE_FRAME_TOL = 1e-5
KW = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)


def _cfg(SC, MC, depth, upload="f32"):
    """tests/test_pipeline.py's configuration."""
    return SC(mapper=MC(max_keyframes=4, max_frames=1, max_factors=16,
                        code_size=4, height=H, width=W, pyramid_levels=2,
                        pho_iters=(4, 6), connection_mode="LASTN",
                        max_back_connections=2, use_schur=False),
              dist_threshold=0.6, frame_dist_threshold=0.5,
              loop_closure=True, loop_active_window=3, loop_max_dist=0.3,
              pipeline_depth=depth, frame_upload=upload)


@pytest.fixture(scope="module")
def scene():
    sc = jsynth.random_room(11, n_boxes=2, freq_scale=0.3)
    poses = jsynth.orbit_trajectory(N, radius=0.5, sweep=1.2 * np.pi)
    frames, depths = jsynth.render_sequence(sc, JCam.create(**KW), poses, H,
                                            W, with_depth=True)
    return ([np.array(f) for f in frames], [np.array(d) for d in depths],
            poses)


def _facades(scene, depth, upload="f32"):
    frames, depths, _ = scene
    jvoc = jvb.random_vocabulary(64)
    jdf = JDF(_cfg(JSC, JMC, depth, upload), JCam.create(**KW),
              decoder=jsynth.OracleDecoder(frames, depths, levels=2,
                                           code_size=4),
              vocabulary=jvoc)
    tdf = TDF(_cfg(TSC, TMC, depth, upload), TCam.create(**KW),
              decoder=tsynth.OracleDecoder(frames, depths, levels=2,
                                           code_size=4),
              vocabulary=tvb.vocabulary_from_numpy(
                  np.asarray(jvoc.words), np.asarray(jvoc.idf), "cpu"),
              device="cpu")
    tdf.mapper.ransac_draw = JaxKeyChain()
    return jdf, tdf


def _run(df, frames, n=N):
    """Feed frames 2..n-1 after a bootstrap on 0 and 1, forcing a keyframe
    before FORCE_KF; one record per retired frame, taken around
    ``_decide``."""
    recs, calls = [], {"pose": 0, "map": 0, "stats": 0}
    df.pose_callback = lambda p: calls.__setitem__("pose", calls["pose"] + 1)
    df.map_callback = lambda s: calls.__setitem__("map", calls["map"] + 1)
    df.stats_callback = lambda s: calls.__setitem__("stats",
                                                    calls["stats"] + 1)
    decide = df._decide
    m = df.mapper

    def recorded(timestamp, nframe, img, out, probe, pose, kf, stale=False):
        n_kid, n_fr = m._next_kid, int(np.array(m.frames.next_id))
        decide(timestamp, nframe, img, out, probe, pose, kf, stale=stale)
        recs.append(dict(nframe=nframe, kf=kf, stale=stale,
                         lost=df.tracking_lost, keyframe=m._next_kid > n_kid,
                         oneway=int(np.array(m.frames.next_id)) > n_fr,
                         d_rate=df._d_rate))

    df._decide = recorded
    df.bootstrap_two_frames(frames[0], frames[1])
    df.trajectory = [(0.0, df.pose_wc)]
    fed_at = {}
    for i in range(2, n):
        if i == FORCE_KF:
            df.force_keyframe()
        fed_at[i] = len(recs)
        df.process_frame(float(i), frames[i])
    df.flush()
    return dict(recs=recs, calls=calls, fed_at=fed_at,
                n_frames=df.n_frames, lost=df.n_lost_frames,
                pending=len(df._pending),
                ts=[ts for ts, _ in df.trajectory],
                q=np.stack([np.array(p.q) for _, p in df.trajectory]),
                t=np.stack([np.array(p.t) for _, p in df.trajectory]),
                evicted=len(df.mapper.archived))


@pytest.fixture(scope="module")
def pair(scene):
    jdf, tdf = _facades(scene, depth=1)
    return dict(jax=_run(jdf, scene[0]), torch=_run(tdf, scene[0]))


def _decisions(r):
    return [{k: v for k, v in rec.items() if k != "d_rate"}
            for rec in r["recs"]]


def test_pipelined_decisions_identical(pair):
    a, b = pair["torch"], pair["jax"]
    assert _decisions(a) == _decisions(b)
    # the run exercises what it must: keyframe events, stale retires,
    # evictions
    assert sum(r["keyframe"] for r in a["recs"]) >= 4
    assert any(r["stale"] for r in a["recs"])
    assert a["evicted"] == b["evicted"] > 0


def test_pipelined_frame_accounting_identical(pair):
    a, b = pair["torch"], pair["jax"]
    assert a["n_frames"] == b["n_frames"] == N - 2
    assert a["lost"] == b["lost"] == 0
    assert a["pending"] == b["pending"] == 0
    assert a["ts"] == b["ts"] and len(a["ts"]) == N - 1
    assert [r["nframe"] for r in a["recs"]] == list(range(1, N - 1))


def test_keyframe_rate_close(pair):
    a = np.array([r["d_rate"] for r in pair["torch"]["recs"]])
    b = np.array([r["d_rate"] for r in pair["jax"]["recs"]])
    assert (b > 0).any()
    np.testing.assert_allclose(a, b, rtol=0, atol=RATE_TOL)


def test_pipelined_poses_close(pair):
    a, b = pair["torch"], pair["jax"]
    np.testing.assert_allclose(a["t"], b["t"], atol=POSE_T_TOL)
    np.testing.assert_allclose(a["q"], b["q"], atol=POSE_Q_TOL)


def test_force_keyframe_fires_at_the_same_frame(pair):
    """The forced keyframe is built by the first retire after the flag that
    is not stale (the frame fed before FORCE_KF is retired while FORCE_KF
    is dispatched), in both packages at the same frame."""
    for name in ("torch", "jax"):
        r = pair[name]
        recs = [x for x in r["recs"][r["fed_at"][FORCE_KF]:]
                if not x["stale"]]
        assert recs[0]["keyframe"], (name, recs[0])
    a, b = pair["torch"], pair["jax"]
    first = lambda r: next(x["nframe"] for x in r["recs"][r["fed_at"][
        FORCE_KF]:] if not x["stale"])
    assert first(a) == first(b)


def test_callbacks_called_as_often(pair):
    a, b = pair["torch"]["calls"], pair["jax"]["calls"]
    assert a == b
    assert a["pose"] == N - 2 and a["map"] >= 4 and a["stats"] > 0


def test_bootstrap_one_frame_pair(scene):
    frames = scene[0]
    jdf, tdf = _facades(scene, depth=0)
    out = {}
    for name, df in (("jax", jdf), ("torch", tdf)):
        df.bootstrap_one_frame(frames[0])
        df.trajectory = [(0.0, df.pose_wc)]
        events = []
        for i in (1, 2, 3):
            if i == 2:
                df.force_frame()
            n_kid = df.mapper._next_kid
            n_fr = int(np.array(df.mapper.frames.next_id))
            df.process_frame(float(i), frames[i])
            events.append((df.mapper._next_kid > n_kid,
                           int(np.array(df.mapper.frames.next_id)) > n_fr))
        out[name] = df
        out[name + " events"] = events
    a, b = out["torch"], out["jax"]
    assert a.n_lost_frames == b.n_lost_frames == 0
    assert len(a.mapper.kf_slots) == len(b.mapper.kf_slots)
    for (ta, pa), (tb, pb) in zip(a.trajectory, b.trajectory):
        assert ta == tb
        np.testing.assert_allclose(np.array(pa.t), np.array(pb.t),
                                   atol=ONE_FRAME_TOL)
        np.testing.assert_allclose(np.array(pa.q), np.array(pb.q),
                                   atol=ONE_FRAME_TOL)
    assert len(a.trajectory) == len(b.trajectory) == 4
    assert out["torch events"] == out["jax events"]
    forced = next(e for e in out["torch events"][1:] if not e[0])
    assert forced[1] and not a.force_frame_flag

