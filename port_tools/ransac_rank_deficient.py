"""RANSAC on rank-deficient hypotheses, inside the JAX package alone.

RANSAC draws its 8 samples with replacement (deepfactors_tpu/features/
matching.py ``prune_matches_eight_point``), so most hypotheses repeat a
match: the 8x9 epipolar system then has more than one null vector, and
which one an SVD returns is decided by rounding. This script shows it
without the port: the window of ``tools/loop_correction_demo.py`` (8
keyframes of random_room(7) at 96x128, the ground-truth decoder,
reprojection factors on) is built up to its fifth keyframe, and that
keyframe event's match + RANSAC runs twice with the same key and
keypoints: through the mapper's jitted function and eagerly (the same
functions, op by op). For each direction it prints the matches, the
inliers each way keeps, how many hypotheses are well posed (the 8th
singular value above 1e-4 of the 1st, in float64) and the most inliers a
well-posed one keeps in float64. A direction whose counts differ, or
exceed that most, was decided by an ill-posed hypothesis.

Run on the CPU from the repository root (about 30 s):
    JAX_PLATFORMS=cpu python port_tools/ransac_rank_deficient.py
Prints one JSON line.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

H, W, N_KF, EVENT = 96, 128, 8, 4
WELL_POSED = 1e-4


def _best_inliers(E, kp0, kp1, valid, cam, threshold):
    """The most inliers of the hypotheses' null vectors E [n, 3, 3], in
    float64: each projected onto the essential manifold, then the
    epipolar residual of prune_matches_eight_point."""
    if not len(E):
        return 0
    from deepfactors_tpu.features import matching as mt
    b0 = np.asarray(mt.bearing_vectors(cam, kp0), np.float64)
    b1 = np.asarray(mt.bearing_vectors(cam, kp1), np.float64)
    u, _, v = np.linalg.svd(E)
    E = u[..., :, :2] @ v[..., :2, :]
    Eb0 = np.einsum("hij,nj->hni", E, b0)
    Etb1 = np.einsum("nj,hjk->hnk", b1, E)
    x = np.sum(b1[None] * Eb0, axis=-1)
    den = (Eb0[..., 0] ** 2 + Eb0[..., 1] ** 2 + Etb1[..., 0] ** 2
           + Etb1[..., 1] ** 2)
    err = x * x / np.maximum(den, 1e-12)
    return int(((err < threshold) & np.asarray(valid)[None]).sum(-1).max())


def main():
    import jax.numpy as jnp

    from deepfactors_tpu.features import matching as mt
    from deepfactors_tpu.geometry import se3 as se3m
    from deepfactors_tpu.geometry.camera import PinholeCamera
    from deepfactors_tpu.geometry.se3 import SE3
    from deepfactors_tpu.io import synth
    from deepfactors_tpu.mapping.mapper import Mapper, MapperConfig

    cam = PinholeCamera.create(fx=110.0, fy=110.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    poses = synth.orbit_trajectory(N_KF, sweep=0.3 * np.pi)
    frames, depths = synth.render_sequence(
        synth.random_room(7, n_boxes=3), cam, poses, H, W, with_depth=True)
    oracle = synth.OracleDecoder(frames, depths, levels=3, code_size=8)
    gt = [se3m.mul(se3m.inverse(poses[0]), p) for p in poses]
    m = Mapper(MapperConfig(
        max_keyframes=8, max_frames=0, max_factors=32, code_size=8,
        height=H, width=W, pyramid_levels=3, pho_iters=(4, 8, 15),
        connection_mode="LASTN", max_back_connections=2, use_schur=False,
        use_reprojection=True), cam, decoder=oracle)
    pairs = m._rep_pair_fn()
    calls = []

    def recorded(kp_xy, kp_desc, kp_valid, ias, ibs, key, n):
        calls.append((ias, ibs, key))
        return pairs(kp_xy, kp_desc, kp_valid, ias, ibs, key, n)

    m._rep_pair_jit = recorded
    for k in range(EVENT + 1):
        m.enqueue_keyframe(np.asarray(frames[k]),
                           SE3(np.asarray(gt[k].q), np.asarray(gt[k].t)))
        while m.has_work():
            m.mapping_run()
        m.update_map()
    ias, ibs, key = calls[-1]
    st, cfg = m.state, m.cfg
    jitted = np.asarray(pairs(st.kp_xy, st.kp_desc, st.kp_valid, ias, ibs,
                              key, len(ias)))
    ks = jax.random.split(key, 2 * len(ias))
    dirs = [d for a, b in zip(np.asarray(ias).tolist(),
                              np.asarray(ibs).tolist())
            for d in ((a, b), (b, a))]
    out = []
    for d, (a, b) in enumerate(dirs):
        mm = mt.match(st.kp_desc[a], st.kp_valid[a], st.kp_desc[b],
                      st.kp_valid[b], max_dist=int(cfg.rep_max_dist))
        kp0, kp1 = st.kp_xy[a], st.kp_xy[b][mm.idx1]
        eager = mt.prune_matches_eight_point.__wrapped__(
            kp0, kp1, mm.valid, cam, ks[d],
            threshold=cfg.rep_ransac_threshold,
            max_iterations=cfg.rep_ransac_maxiters) & mm.valid
        # the hypotheses' draws, as prune_matches_eight_point makes them
        idx = np.asarray(jax.random.categorical(
            ks[d], jnp.where(mm.valid, 0.0, -1e9),
            shape=(cfg.rep_ransac_maxiters, 8)))
        b0 = np.asarray(mt.bearing_vectors(cam, kp0), np.float64)[idx]
        b1 = np.asarray(mt.bearing_vectors(cam, kp1), np.float64)[idx]
        A = (b1[..., :, None] * b0[..., None, :]).reshape(idx.shape[0], 8, 9)
        _, sv, vt = np.linalg.svd(A, full_matrices=True)
        posed = sv[:, 7] > WELL_POSED * sv[:, 0]
        out.append(dict(
            direction=[a, b], matches=int(np.asarray(mm.valid).sum()),
            inliers_jitted=int((jitted[d, :, 4] > 0.5).sum()),
            inliers_eager=int(np.asarray(eager).sum()),
            well_posed_hypotheses=int(posed.sum()),
            best_well_posed_inliers_f64=_best_inliers(
                vt[posed, -1].reshape(-1, 3, 3), kp0, kp1, mm.valid, cam,
                cfg.rep_ransac_threshold),
            hypotheses=int(idx.shape[0])))
    print(json.dumps({"keyframe_event": EVENT, "directions": out}))


if __name__ == "__main__":
    main()
