"""Tracking loss and relocalisation of the deepfactors_tpu_torch facade
against the JAX facade (deepfactors.cpp:713-743, 852-879).

1. The pair of tests/test_relocalization.py (48x64, 2 levels, no
   decoder, a strict error threshold so that a garbage frame trips the
   lost check): a noise frame is lost in both, the next good frame
   relocalises against the live keyframes (the batched verification at
   P = max_keyframes) in both, and the relocalised poses agree within
   1e-4 m (the verification's tolerance, tests/test_torch_loop.py), near
   the map.
2. An archived relocalisation: the 48x64 room orbit of
   tests/test_torch_system.py with a window of 4 keyframes and loop
   closure on, keyframes every frame or two, so that the first keyframes
   are evicted into the loop detector's archive. A noise frame is lost;
   then the bootstrap frame comes back. No live keyframe sees it, so both
   packages relocalise against the archive (the verification at P =
   archive_cap), resurrect the same archived keyframe into the same slot
   at its archived pose with a loop prior, and go on tracking. Decisions
   (keyframes, evictions, losses, relocalisations, loop counters) must be
   identical; the relocalised pose and the frames after it within
   3e-2 m / 1e-2 of each other, the tolerance of the facade pairs of
   tests/test_torch_system.py (bf16 decoder rounding carried along the
   chain), and within 0.1 m of the truth.
3. A loop-on facade pair (the shipped vocabulary, reprojection off, an
   active window of 2 keyframes) on the 48x64 orbit of
   tests/test_torch_system.py, 12 frames forward and back to frame 0:
   keyframe decisions, losses, relocalisations and the loop links (local,
   live global, archived, in order) must be identical, and a global loop
   must close; the poses within the same tolerances, the ATE within 1e-2 m
   (found: one frame lost on the way back, and one live global loop, in
   both)."""
import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params
from test_torch_system import ATE_TOL, _cfg, _run

from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.loop import vocabulary as jvb
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.models.decoder import Decoder as JDec
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu.system import DeepFactors as JDF
from deepfactors_tpu.system import SystemConfig as JSC
from deepfactors_tpu.utils import tum_io as jtum
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.loop import vocabulary as tvb
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.models.decoder import Decoder as TDec
from deepfactors_tpu_torch.models.decoder import NetworkConfig as TNC
from deepfactors_tpu_torch.system import DeepFactors as TDF
from deepfactors_tpu_torch.system import SystemConfig as TSC
from deepfactors_tpu_torch.utils import tum_io as ttum

torch.set_num_threads(2)
H, W = 48, 64
RELOC_TOL = 1e-4
POSE_T_TOL, POSE_Q_TOL = 3e-2, 1e-2
# the shipped vocabulary, given to both packages (with none the JAX
# facade's detector draws a random one, the port's loads the shipped one)
JVOC = dict(vocabulary=jvb.default_vocabulary())
TVOC = dict(vocabulary=tvb.default_vocabulary(device="cpu"))


def _plain_pair(SC, MC, loop_closure):
    return SC(mapper=MC(max_keyframes=4, max_frames=1, max_factors=8,
                        code_size=4, height=H, width=W, pyramid_levels=2,
                        pho_iters=(3, 4), use_schur=False,
                        use_reprojection=False),
              tracking_iterations=(6, 5),
              tracking_error_threshold=0.01,  # a garbage frame trips it
              keyframe_mode="NEVER", loop_closure=loop_closure)


@pytest.mark.parametrize("loop_closure", [False, True])
def test_lost_and_relocalize_matches_jax(loop_closure):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (0.5 + 0.3 * np.sin(xs / 5) * np.cos(ys / 4)).astype(np.float32)
    noise = np.random.RandomState(0).rand(H, W).astype(np.float32)
    kw = dict(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2, width=W, height=H)
    out = {}
    for name, df in (
            ("jax", JDF(_plain_pair(JSC, JMC, loop_closure), JCam.create(**kw),
                        decoder=None, **JVOC)),
            ("torch", TDF(_plain_pair(TSC, TMC, loop_closure),
                          TCam.create(**kw), decoder=None, device="cpu",
                          **TVOC))):
        df.bootstrap_two_frames(img, img)
        assert not df.tracking_lost
        n_traj = len(df.trajectory)
        df.process_frame(2.0, noise)
        lost = (df.tracking_lost, len(df.trajectory) - n_traj)
        df.process_frame(3.0, img)
        out[name] = dict(lost=lost, after=df.tracking_lost,
                         n=len(df.trajectory) - n_traj,
                         n_reloc=df.n_relocalizations,
                         n_lost=df.n_lost_frames, kf=df.curr_kf,
                         t=np.array(df.pose_wc.t), q=np.array(df.pose_wc.q))
    a, b = out["torch"], out["jax"]
    assert a["lost"] == b["lost"] == (True, 0)      # the noise frame dropped
    assert a["after"] is b["after"] is False        # relocalised
    assert a["n"] == b["n"] == 1
    assert a["n_reloc"] == b["n_reloc"] == 1 and a["n_lost"] == b["n_lost"] == 1
    assert a["kf"] == b["kf"]
    np.testing.assert_allclose(a["t"], b["t"], atol=RELOC_TOL)
    np.testing.assert_allclose(a["q"], b["q"], atol=RELOC_TOL)
    assert np.linalg.norm(a["t"]) < 0.05


N_ARCH = 12          # frames of the orbit before the loss


def _arch_cfg(SC, MC):
    return SC(mapper=MC(max_keyframes=4, max_frames=2, max_factors=16,
                        code_size=4, height=H, width=W, pyramid_levels=2,
                        pho_iters=(4, 8), max_back_connections=2,
                        use_reprojection=False),
              tracking_iterations=(10, 5), dist_threshold=0.5,
              tracking_dist_threshold=5.0, frame_dist_threshold=0.12,
              loop_closure=True, loop_archive_cap=8)


def _arch_run(df, frames):
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    df.trajectory = [(0.0, df.pose_wc)]
    evicted, log = [], []
    on_evict = df.mapper.evict_callback

    def record(slot, kid):
        evicted.append((slot, kid))
        on_evict(slot, kid)

    df.mapper.evict_callback = record
    noise = np.random.RandomState(1).rand(H, W).astype(np.float32)
    seq = [(float(i), frames[i]) for i in range(3, N_ARCH)]
    seq += [(100.0, noise), (0.5, frames[0]), (1.0, frames[1])]
    for ts, img in seq:
        n_kf = df.mapper._next_kid
        df.process_frame(ts, img)
        log.append(dict(
            ts=ts, lost=df.tracking_lost, kf=df.mapper._next_kid > n_kf,
            reloc=df.n_relocalizations, slot=df.curr_kf,
            arch=df.loop_detector.arch_ids.tolist(),
            prior=bool(np.array(df.mapper.marginals.active)[df.curr_kf])))
    return dict(
        log=log, evicted=evicted,
        counters=(df.n_lost_frames, df.n_relocalizations, df.n_local_links,
                  df.n_live_global_loops, df.n_archived_loops),
        slots=list(df.mapper.kf_slots), ts=[ts for ts, _ in df.trajectory],
        t=np.stack([np.array(p.t) for _, p in df.trajectory]),
        q=np.stack([np.array(p.q) for _, p in df.trajectory]))


@pytest.fixture(scope="module")
def arch_runs():
    kw = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)[:N_ARCH]
    frames = [np.array(f) for f in
              jsynth.render_sequence(scene, JCam.create(**kw), poses, H, W)]
    ncfg = dict(code_size=4, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    return dict(
        jax=_arch_run(JDF(_arch_cfg(JSC, JMC), JCam.create(**kw),
                          decoder=JDec(JNC(**ncfg), params=params), **JVOC),
                      frames),
        torch=_arch_run(TDF(_arch_cfg(TSC, TMC), TCam.create(**kw),
                            decoder=TDec(TNC(**ncfg), params=params,
                                         device="cpu"), device="cpu", **TVOC),
                        frames))


def test_archived_relocalisation_decisions_identical(arch_runs):
    a, b = arch_runs["torch"], arch_runs["jax"]
    assert a["log"] == b["log"]
    assert a["evicted"] == b["evicted"] and len(a["evicted"]) >= 2
    assert a["counters"] == b["counters"]
    assert a["slots"] == b["slots"] and a["ts"] == b["ts"]
    i = [e["ts"] for e in a["log"]].index(100.0)
    lost, back = a["log"][i], a["log"][i + 1]
    assert lost["lost"] and lost["reloc"] == 0       # the noise frame
    assert not back["lost"] and back["reloc"] == 1   # relocalised ...
    # ... against the archive: one archived keyframe is live again (its
    # archive row retired), tracked against, pinned by a loop prior
    gone = [j for j, (x, y) in enumerate(zip(lost["arch"], back["arch"]))
            if x >= 0 and y == -1]
    assert len(gone) == 1 and back["prior"]


def test_archived_relocalisation_poses_close(arch_runs):
    a, b = arch_runs["torch"], arch_runs["jax"]
    np.testing.assert_allclose(a["t"], b["t"], atol=POSE_T_TOL)
    np.testing.assert_allclose(a["q"], b["q"], atol=POSE_Q_TOL)
    # the relocalised pose is near the truth (the bootstrap frame's pose is
    # the world origin)
    i = a["ts"].index(0.5)
    assert np.linalg.norm(a["t"][i]) < 0.1


def _cfg_loop(SC, MC):
    """Loop closure on (the shipped vocabulary), reprojection off (too few
    corners at 48x64: a live global loop then links photometrically), an
    active window of 2 keyframes, keyframes at half the default distance,
    a factor pool for the links."""
    return _cfg(SC, MC)._replace(
        mapper=_cfg(SC, MC).mapper._replace(max_factors=32),
        dist_threshold=1.0, loop_closure=True, loop_active_window=2)


def _both_loop():
    """The orbit forward over 12 frames, then back to frame 0: the way back
    revisits keyframes outside the active window."""
    kw = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    n = 12
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)[:n]
    frames = [np.array(f) for f in
              jsynth.render_sequence(scene, JCam.create(**kw), poses, H, W)]
    schedule = list(range(3, n)) + list(range(n - 2, -1, -1))
    ncfg = dict(code_size=4, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    return dict(
        jax=_run(JDF(_cfg_loop(JSC, JMC), JCam.create(**kw),
                     decoder=JDec(JNC(**ncfg), params=params), **JVOC),
                 frames, poses, jtum, schedule=schedule),
        torch=_run(TDF(_cfg_loop(TSC, TMC), TCam.create(**kw),
                       decoder=TDec(TNC(**ncfg), params=params, device="cpu"),
                       device="cpu", **TVOC),
                   frames, poses, ttum, schedule=schedule))


@pytest.fixture(scope="module")
def runs_loop():
    return _both_loop()


def test_loop_run_decisions_and_counters_identical(runs_loop):
    """Loop closure on, on a path that comes back: the same keyframe and
    one-way-frame decisions, losses and relocalisations, and the same loop
    links (local, live global, archived) in the same order."""
    a, b = runs_loop["torch"], runs_loop["jax"]
    assert a["kf"] == b["kf"] and a["fr"] == b["fr"]
    assert a["loops"] == b["loops"]
    assert a["loops"][1] + a["loops"][2] >= 1        # a global loop closed
    assert a["lost"] == b["lost"] and a["ts"] == b["ts"]


def test_loop_run_poses_close(runs_loop):
    a, b = runs_loop["torch"], runs_loop["jax"]
    np.testing.assert_allclose(a["t"], b["t"], atol=POSE_T_TOL)
    np.testing.assert_allclose(a["q"], b["q"], atol=POSE_Q_TOL)
    assert abs(a["ate"] - b["ate"]) < ATE_TOL
