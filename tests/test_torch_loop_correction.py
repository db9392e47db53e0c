"""The drift-injection check of loop closure, the port against the JAX
package on the CPU: ``port_tools/loop_correction_demo.py`` and the steps
of ``tools/loop_correction_demo.py``, run here side by side. A window of 8
keyframes at 96x128 with the ground-truth decoder and reprojection factors
on; 0.3 m / 0.1 rad of drift injected into the newest keyframe; the loop
closed by the archived path (a pose prior), the live path (the prior and a
reprojection link) and a bare reprojection link.

Both packages see the same views (the JAX renderer's) and the same RANSAC
draws (the port replays the JAX mapper's key chain, ``JaxKeyChain``).
RANSAC draws its 8 samples with replacement, so most hypotheses repeat a
match: their 8x9 system is rank deficient and each SVD returns its own
null vector (the JAX package itself keeps 9 inliers on one direction of
this window jitted and 7 eagerly, ``port_tools/ransac_rank_deficient.py``).
So the test splits RANSAC from what follows it:
  - RANSAC: at every match + RANSAC call of the run (the window's 7
    keyframe events and the two links), the port's matches are JAX's, and
    every full-rank hypothesis (8 distinct matches) marks the same inliers
    in both; where the two packages keep different inlier counts, the
    larger count comes from a rank-deficient hypothesis;
  - after RANSAC, the port's mapper takes the JAX package's inlier masks
    (the port's own RANSAC result is replaced by JAX's at each call), so
    the window, the three loop paths and the reprojection factors each adds
    can be held to JAX's tightly.

Tolerances: the window's poses and the pose errors before and after,
POSE_TOL = 1e-4 (the readings differ by 3.1e-6 over the window, 2.7e-6
before and 3.7e-7 after); the removed share, SHARE_TOL = 1e-4 (read:
9e-7). The reprojection factors between the
newest and the first keyframe: the same directions with the same match
counts."""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapper_rep import JaxKeyChain

from deepfactors_tpu.features import matching as jmt
from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.mapping.mapper import Mapper as JMapper
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu_torch.features import matching as tmt
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port_tools"))
import loop_correction_demo as demo  # noqa: E402

torch.set_num_threads(2)
H, W, N = demo.H, demo.W, demo.N_KF
POSE_TOL = 1e-4
SHARE_TOL = 1e-4
WELL_POSED = 1e-4
DRIFT_T, DRIFT_YAW = 0.30, 0.10


def _images():
    cam = JCam.create(fx=110.0, fy=110.0, u0=W / 2, v0=H / 2, width=W,
                      height=H)
    poses = jsynth.orbit_trajectory(N, sweep=0.3 * np.pi)
    frames, depths = jsynth.render_sequence(
        jsynth.random_room(7, n_boxes=3), cam, poses, H, W, with_depth=True)
    return cam, poses, np.asarray(frames), np.asarray(depths)


def _loop_factors(m, last, first):
    p = m.rep_pool
    return [[int(p.src[i]), int(p.dst[i]), int(np.asarray(p.mvalid[i]).sum())]
            for i in np.nonzero(np.asarray(p.active))[0]
            if {int(p.src[i]), int(p.dst[i])} == {last, first}]


def _copy_mapper(m):
    """A copy of a JAX Mapper whose host and device state is its own; what
    cannot be copied (the module handles and the jitted functions, which
    hold no state) is shared."""
    c = copy.copy(m)
    for k, v in m.__dict__.items():
        try:
            setattr(c, k, copy.deepcopy(v))
        except TypeError:
            pass
    return c


def _jax_run(cam, poses, frames, depths):
    """The steps of tools/loop_correction_demo.py with the JAX package, the
    window built once and copied for each path (the tool builds it three
    times from the same key chain, so each path starts from the same
    window). Records every match + RANSAC call's packed [2n, M, 5]
    output."""
    oracle = jsynth.OracleDecoder(jnp.asarray(frames), jnp.asarray(depths),
                                  levels=3, code_size=8)
    gt = [jse3.mul(jse3.inverse(poses[0]), p) for p in poses]
    m = JMapper(JMC(max_keyframes=8, max_frames=0, max_factors=32,
                    code_size=8, height=H, width=W, pyramid_levels=3,
                    pho_iters=(4, 8, 15), connection_mode="LASTN",
                    max_back_connections=2, use_schur=False,
                    use_reprojection=True), cam, decoder=oracle)
    calls = []
    pairs = m._rep_pair_fn()

    def recorded(*a, **k):
        out = pairs(*a, **k)
        calls.append(np.asarray(out))
        return out

    m._rep_pair_jit = recorded

    def settle(m):
        while m.has_work():
            m.mapping_run()
        m.update_map()

    def err(m, slot, k):
        est = jse3.index(m.state.pose, slot)
        return float(jnp.linalg.norm(jse3.local(gt[k], est)))

    slots = []
    for k in range(N):
        slots.append(m.enqueue_keyframe(frames[k], JSE3(np.asarray(gt[k].q),
                                                        np.asarray(gt[k].t))))
        settle(m)
    last, first = slots[-1], slots[0]
    dq = jse3.so3_exp_quat(jnp.asarray([0.0, DRIFT_YAW, 0.0]))
    q, t = m.state.pose.q, m.state.pose.t
    m.state = m.state._replace(pose=JSE3(
        q.at[last].set(jse3.quat_mul(dq, q[last])),
        t.at[last].add(jnp.asarray([DRIFT_T, 0.0, 0.0]))))
    truth = JSE3(np.asarray(gt[-1].q), np.asarray(gt[-1].t))
    window = np.concatenate([np.asarray(m.state.pose.q),
                             np.asarray(m.state.pose.t)], axis=1)
    out = {}
    for path in demo.PATHS:
        mp = _copy_mapper(m)
        mp._rep_pair_jit = recorded
        before = err(mp, last, N - 1)
        if path != "bare_rep_link_ablation":
            mp.add_loop_prior(last, truth, sigma=0.05)
            mp._add_photo_pair(last, slots[-2], second_removes=True)
        if path != "archived_prior":
            mp.enqueue_link(last, first, photo=False, rep=True)
        settle(mp)
        after = err(mp, last, N - 1)
        out[path] = {"pose_err_before": before, "pose_err_after": after,
                     "removed_fraction": 1.0 - after / before,
                     "loop_rep_factors": _loop_factors(mp, last, first)}
    return out, calls, window


@pytest.fixture(scope="module")
def runs():
    cam, poses, frames, depths = _images()
    ref, jax_calls, jax_window = _jax_run(cam, poses, frames, depths)
    # the port's RANSAC runs on the JAX draws, is recorded, and its result
    # is replaced by the JAX package's inliers of the same call
    pending = list(jax_calls)
    seen = []
    own = tmt.prune_matches_eight_point

    def replay(kp0, kp1, valid, cam, idx=None, threshold=1e-4, **kw):
        mine = own(kp0, kp1, valid, cam, idx=idx, threshold=threshold, **kw)
        ref_call = pending.pop(0)
        seen.append(dict(kp0=kp0.numpy(), kp1=kp1.numpy(),
                         valid=valid.numpy(), idx=idx.numpy(),
                         threshold=threshold, mine=(mine & valid).numpy(),
                         ref=ref_call))
        return torch.as_tensor(ref_call[..., 4] > 0.5)

    window = {}
    tmt.prune_matches_eight_point = replay
    try:
        port = demo.run("cpu", DRIFT_T, DRIFT_YAW, ransac_draw=JaxKeyChain,
                        images=(frames, depths), window_out=window)
    finally:
        tmt.prune_matches_eight_point = own
    return dict(ref=ref, port=port, calls=seen, left=pending,
                window=(jax_window, window["pose"]), cam=cam, posed={})


def test_every_ransac_call_replayed(runs):
    # 7 keyframe events (the first has no back-connection) and the live
    # and bare links
    assert len(runs["calls"]) == N - 1 + 2
    assert not runs["left"]


def _hypothesis_inliers(call, jcam):
    """Inlier masks [2n, I, M] of every hypothesis of one call, JAX (jitted,
    as in its mapper) and port, on the port's matches and draws; and which
    hypotheses are well posed [2n, I]: the 8x9 epipolar system has one null
    vector, its 8th singular value above WELL_POSED of its 1st in float64
    (numpy)."""
    b0 = jmt.bearing_vectors(jcam, jnp.asarray(call["kp0"]))
    b1 = jmt.bearing_vectors(jcam, jnp.asarray(call["kp1"]))

    @jax.jit
    def masks(b0, b1, idx, valid):
        Es = jax.vmap(lambda i: jmt._essential_from_8(b0[i], b1[i]))(idx)
        errs = jax.vmap(lambda E: jmt._epipolar_error(E, b0, b1))(Es)
        return (errs < call["threshold"]) & valid[None]

    idx = call["idx"]
    ref = np.stack([np.asarray(masks(b0[d], b1[d], idx[d], call["valid"][d]))
                    for d in range(idx.shape[0])])
    tcam = TCam.create(fx=jcam.fx, fy=jcam.fy, u0=jcam.u0, v0=jcam.v0,
                       width=W, height=H)
    tb0 = tmt.bearing_vectors(tcam, torch.as_tensor(call["kp0"]))
    tb1 = tmt.bearing_vectors(tcam, torch.as_tensor(call["kp1"]))
    g0, g1 = (torch.stack([b[d][torch.as_tensor(idx[d]).long()]
                           for d in range(idx.shape[0])]) for b in (tb0, tb1))
    mine = ((tmt._epipolar_error(tmt._essential_from_8(g0, g1), tb0, tb1)
             < call["threshold"])
            & torch.as_tensor(call["valid"])[:, None]).numpy()
    g0, g1 = g0.double().numpy(), g1.double().numpy()
    A = (g1[..., :, :, None] * g0[..., :, None, :]).reshape(g0.shape[:-2]
                                                           + (8, 9))
    sv = np.linalg.svd(A, compute_uv=False)
    return ref, mine, sv[..., 7] > WELL_POSED * sv[..., 0]


@pytest.mark.parametrize("i", range(N + 1))
def test_ransac_call_matches_jax(runs, i):
    call = runs["calls"][i]
    ref = call["ref"]
    jvalid = ref[..., 4] > 0.5
    # the same matches: kp0 of every row, kp1 of every valid match, and the
    # JAX inliers among the port's valid matches
    v = call["valid"]
    np.testing.assert_array_equal(call["kp0"], ref[..., 0:2])
    np.testing.assert_array_equal(call["kp1"][v], ref[..., 2:4][v])
    assert not (jvalid & ~v).any()
    ref_h, mine_h, posed = _hypothesis_inliers(call, runs["cam"])
    np.testing.assert_array_equal(mine_h[posed], ref_h[posed])
    runs["posed"][i] = int(posed.sum())
    for d in range(v.shape[0]):
        n_ref, n_mine = int(jvalid[d].sum()), int(call["mine"][d].sum())
        best_posed = int(ref_h[d][posed[d]].sum(-1).max(initial=0))
        assert min(n_ref, n_mine) >= best_posed
        if n_ref != n_mine:
            # the larger count was won by an ill-posed hypothesis
            assert max(n_ref, n_mine) > best_posed


def test_ransac_checks_saw_well_posed_hypotheses(runs):
    # the well-posed hypotheses the checks above compared (1,000 of the
    # run's 3,584)
    assert len(runs["posed"]) == N + 1
    assert sum(runs["posed"].values()) >= 500


def test_window_matches_jax(runs):
    jw, tw = runs["window"]
    np.testing.assert_allclose(tw, jw, atol=POSE_TOL)


@pytest.mark.parametrize("path", demo.PATHS)
def test_removed_share_matches_jax(runs, path):
    r, j = runs["port"][path], runs["ref"][path]
    for k in ("pose_err_before", "pose_err_after"):
        assert abs(r[k] - j[k]) < POSE_TOL, (k, r[k], j[k])
    assert abs(r["removed_fraction"] - j["removed_fraction"]) < SHARE_TOL


@pytest.mark.parametrize("path", demo.PATHS)
def test_loop_rep_factors_match_jax(runs, path):
    r, j = runs["port"][path], runs["ref"][path]
    assert sorted(r["loop_rep_factors"]) == sorted(j["loop_rep_factors"])
