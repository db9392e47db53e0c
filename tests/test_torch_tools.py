"""The port's tools (deepfactors_tpu_torch/tools) against the JAX package's
(tools/ and the functions they call), on the CPU, at small sizes:

  - ``schur_crossover.build_system(K)``: H and b within 1e-5 of JAX's
    (relative to each one's largest entry; the two assemble in another
    summation order), and the dense and the Schur solutions within 1e-4 of
    JAX's (relative L2), at K = 4 and 8;
  - ``kernel_benchmark`` at 48x64, CS 8: the ``sfm_step`` rows' JtJ (the
    batched rows and the one-factor sampled row) against JAX's
    ``dense_sfm.sfm_step``, ``se3_step`` per level against JAX's, and the
    Gram rows (``sfm_gram_batch`` / ``se3_gram_batch`` at B = 1, 8, 16,
    ``se3_warp_batch``) against JAX's Pallas kernels in interpret mode,
    within tests/test_torch_sfm_gram.py's tolerance (1e-4 of a block's
    largest entry; inlier counts exact; ``_blocks`` says how Jtr and the
    residual, round-off on this problem, are held); blur, Sobel and
    update_depth within 1e-6;
  - ``test_matching`` on frames 26 and 30 of room 7's orbit at 192x256
    (``chip_smoke.py`` phase 2b's pair): the keypoint and match counts the
    JAX tool prints; with JAX's draws (``jax.random.categorical`` under
    PRNGKey(0), as the JAX tool draws; the well-posed hypotheses) the
    inlier count and mask of JAX's ``prune_matches_eight_point`` on them
    (but matches on the threshold); the match image as the JAX tool draws
    it with cv2, decoded pixel for pixel; ``draw_line`` against
    ``cv2.line`` on random lines;
  - ``voc_builder`` / ``voc_test``: a vocabulary ``.npz`` written by each
    package loads in the other with the same words (uint32) and idf
    (float32), and the port's BoW scores on the port's descriptors equal
    JAX's within 1e-6;
  - ``profile_ba``'s stages on the bench mapper: its dense and Schur
    stages solve the same system; the stages and ``profile_dispatch``'s
    n0 probe run on the CPU;
  - every entry refuses ``--device cuda`` without a card, and the tools
    run through ``python -m``.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.loop import vocabulary as jvb
from deepfactors_tpu.ops import dense_sfm as jds
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu.ops.pallas import sfm_kernel as jsk
from deepfactors_tpu.solver import system as jsys
from deepfactors_tpu_torch.io import image_io
from deepfactors_tpu_torch.loop import vocabulary as tvb
from deepfactors_tpu_torch.tools import kernel_benchmark as kb
from deepfactors_tpu_torch.tools import schur_crossover as tsc
from deepfactors_tpu_torch.tools import test_matching as ttm
from deepfactors_tpu_torch.tools import voc_builder as tvbld
from deepfactors_tpu_torch.tools import voc_test as tvt
from tools import schur_crossover as jsc
from tools import test_matching as jtm
from tools import voc_builder as jvbld

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4            # tests/test_torch_sfm_gram.py's block tolerance


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("K", [4, 8])
def test_schur_crossover_system_and_solves_match_jax(K):
    tg = tsc.build_system(K)
    jg = jsc.build_system(K)
    for a, b in ((tg.H, jg.H), (tg.b, jg.b)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    lam = tsc.LAM
    assert _rel(jsys.solve_damped(jg, jnp.float32(lam)),
                jsys.solve_schur_codes(jg, K, tsc.CS, jnp.float32(lam))) < 1e-3
    pairs = ((tsc.sysm.solve_damped(tg, lam),
              jsys.solve_damped(jg, jnp.float32(lam))),
             (tsc.sysm.solve_schur_codes(tg, K, tsc.CS, lam),
              jsys.solve_schur_codes(jg, K, tsc.CS, jnp.float32(lam))))
    for t_sol, j_sol in pairs:
        assert _rel(t_sol.numpy(), j_sol) < 1e-4
    rows = tsc.main([str(K), "--device", "cpu", "--n", "2"], log=lambda s: 0)
    assert rows[0]["D"] == 38 * K + 6 and rows[0]["rel_err"] < 1e-3


def _blocks(Gt, Gj, DB):
    """JtJ within TOL of its largest entry, the inlier count exact. The
    benchmark's problem (the JAX tool's) warps the img0 pool onto itself at
    the identity pose, so every residual is round-off (Σr² ~ 2e-13 over
    2,596 pixels at 48x64: |r| ~ 1e-8) and Jtr and Σr² are noise that two
    summation orders do not reproduce (found 1.1% of Jtr's bound apart).
    They are held, on both sides, to what round-off allows: Σr² under
    n·1e-14 (every |r| under 1e-7) and each |Jtr_i| under its
    Cauchy-Schwarz bound sqrt(JtJ_ii · Σr²). Jtr and the residual with a
    signal are held to the Pallas kernels in tests/test_torch_sfm_gram.py."""
    Gt, Gj = np.asarray(Gt), np.asarray(Gj)
    J = Gj[:, :DB, :DB]
    np.testing.assert_allclose(Gt[:, :DB, :DB], J, rtol=0,
                               atol=TOL * np.abs(J).max())
    n = Gj[:, DB + 1, DB + 1]
    np.testing.assert_array_equal(Gt[:, DB + 1, DB + 1], n)
    for G in (Gt, Gj):
        res = G[:, DB, DB]
        assert (res <= n * 1e-14).all(), res
        bound = np.sqrt(np.diagonal(G[:, :DB, :DB], axis1=1, axis2=2)
                        * res[:, None])
        assert (np.abs(G[:, :DB, DB]) <= bound * (1 + 1e-5) + 1e-20).all()


def test_kernel_benchmark_rows_match_jax():
    H, W, CS = 48, 64, 8
    pr = kb.build_problem(W, H, CS, "cpu")
    rows = {(name, B): fn for name, B, fn in kb.sweep(pr)}
    n = lambda x: jnp.asarray(x.numpy())
    img0, img1, dpt0, jac0 = (n(pr[k]) for k in ("img0", "img1", "dpt0",
                                                  "jac0"))
    cam = JCam.create(fx=0.9 * W, fy=0.9 * W, u0=W / 2, v0=H / 2, width=W,
                      height=H)
    grad1 = jip.sobel_gradients(img1)
    np.testing.assert_allclose(pr["grad1"].numpy(), grad1, atol=1e-6)
    p0 = jse3.identity()
    params = jds.SfmParams(0.3, 2.0, 0.0, 2)
    sj, _ = jds.sfm_step(p0, p0, jnp.zeros(CS), cam, img0, img1, dpt0,
                         jnp.zeros((H, W)), jac0, grad1, params)
    ref = np.asarray(sj.JtJ)
    atol = TOL * np.abs(ref).max()
    for B in (1, 2, 4, 8, 16):
        JtJ = rows[("sfm_step (44-dim system)", B)]().numpy()
        assert JtJ.shape == (B, 12 + CS, 12 + CS)
        np.testing.assert_allclose(JtJ, np.broadcast_to(ref, JtJ.shape),
                                   rtol=0, atol=atol)
    np.testing.assert_allclose(
        rows[("sfm_step sampled (one factor)", 1)]().numpy(), ref, rtol=0,
        atol=atol)
    for level in range(3):
        h, w = H >> level, W >> level
        i1 = img1[:h, :w]
        sj = jds.se3_step(p0, cam.level(level), img0[:h, :w], i1,
                          jnp.full((h, w), 2.0), jip.sobel_gradients(i1), 0.3)
        r = np.asarray(sj.JtJ)
        np.testing.assert_allclose(rows[(f"se3_step level {level}", 1)]()
                                   .numpy(), r, rtol=0,
                                   atol=TOL * np.abs(r).max())
    np.testing.assert_allclose(rows[("gaussian_blur_down", 1)]().numpy(),
                               jip.gaussian_blur_down(img0), atol=1e-6)
    np.testing.assert_allclose(rows[("sobel_gradients", 1)]().numpy(),
                               jip.sobel_gradients(img0), atol=1e-6)
    np.testing.assert_allclose(
        rows[("update_depth (code->dpt)", 1)]().numpy(),
        jip.update_depth(jnp.zeros(CS), img0 * 0 + 0.5, jac0, 2.0),
        atol=1e-6)

    # the fused kernels over the pool, against the Pallas kernels
    P = kb.POOL
    imgs = jnp.stack([img0] * P)
    dpts = jnp.stack([dpt0] * P)
    jacT = jnp.stack([jnp.transpose(jac0, (2, 0, 1))] * P)
    gxs = jnp.stack([grad1[..., 0]] * P)
    gys = jnp.stack([grad1[..., 1]] * P)
    for B in (1, 8, 16):
        src = jnp.asarray(np.arange(B) % P, jnp.int32)
        dst = jnp.asarray((np.arange(B) + 1) % P, jnp.int32)
        kp = jsk.make_sfm_params(JSE3(jnp.tile(p0.q, (B, 1)),
                                      jnp.tile(p0.t, (B, 1))),
                                 cam, 2, 0.0, 0.3, 2.0)
        _blocks(rows[("sfm_gram_batch", B)](),
                jsk.sfm_gram_batch(kp, src, dst, imgs, dpts, jacT, imgs,
                                   gxs, gys, interpret=True), 6 + CS)
        _blocks(rows[("se3_gram_batch", B)](),
                jsk.se3_gram_batch(kp, src, dst, imgs, dpts, imgs, gxs, gys,
                                   interpret=True), 6)
    z = jnp.zeros((1,), jnp.int32)
    kp = jsk.make_sfm_params(JSE3(p0.q[None], p0.t[None]), cam, 1, 0.0,
                             0.1, 2.0)
    wt, rt, it = rows[("se3_warp_batch", 1)]()
    wj, rj, ij = jsk.se3_warp_batch(kp, z, z, imgs[:1], dpts[:1], imgs[:1],
                                    interpret=True)
    np.testing.assert_allclose(wt.numpy(), wj, atol=1e-5)
    np.testing.assert_array_equal(it.numpy(), ij)
    assert (np.maximum(rt.numpy(), np.asarray(rj)) <= it.numpy() * 1e-14).all()

    out = kb.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                   "--cs", str(CS), "--n", "1"], log=lambda s: 0)
    assert len(out) == len(rows) == 19
    assert all(r["host_ms"] > 0 and r["event_us"] is None for r in out)


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    """Frames 26 and 30 of room 7's orbit at 192x256 (chip_smoke.py phase
    2b's pair), as the PNGs of a files:// source."""
    H, W = 192, 256
    cam = JCam.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2, width=W,
                      height=H)
    poses = jsynth.orbit_trajectory(300, sweep=3.2 * np.pi)
    frames = jsynth.render_sequence(jsynth.random_room(7, n_boxes=3), cam,
                                    [poses[26], poses[30]], H, W)
    d = tmp_path_factory.mktemp("pair")
    for i, f in enumerate(frames):
        image_io.imwrite(str(d / f"{i:02d}.png"),
                         (np.clip(np.asarray(f), 0, 1) * 255 + 0.5)
                         .astype(np.uint8))
    return str(d)


def _jax_draws(valids, iters):
    """The JAX tool's draws (categorical under PRNGKey(0), one row), but
    only the hypotheses of 8 distinct matches: one that repeats a match is
    rank deficient, and its null vector is each SVD's own (ROADMAP C; on
    this pair JAX's winner repeats match 6 and reads 23 inliers in JAX, 1
    in the port)."""
    v = jnp.asarray(np.asarray(valids)[0])
    idx = np.array(jax.random.categorical(
        jax.random.PRNGKey(0), jnp.where(v, 0.0, -1e9), shape=(iters, 8)))
    return idx[[len(set(r)) == 8 for r in idx]][None]


def test_test_matching_matches_jax_with_its_draws(pair_dir, tmp_path,
                                                  capsys):
    from deepfactors_tpu.features import detector as jdet
    from deepfactors_tpu.features import matching as jmt
    from deepfactors_tpu.io import drivers as jdrv

    src = "files://" + pair_dir
    assert jtm.main(["--source", src, "--out", str(tmp_path / "j.png")]) == 0
    said = capsys.readouterr().out
    kps = tuple(int(x) for x in re.search(r"keypoints: (\d+) / (\d+)",
                                          said).groups())
    nm = int(re.search(r"matches: (\d+)", said).group(1))
    out_t = str(tmp_path / "port.png")
    r = ttm.main(["--source", src, "--out", out_t, "--device", "cpu"],
                 ransac_draw=_jax_draws, log=lambda s: 0)
    assert r["keypoints"] == kps and r["matches"] == nm
    # the tool's single-scale detector finds 25 matches on this pair
    # (phase 2b's pyramid detector ~90)
    assert nm >= 20, nm
    # JAX's prune_matches_eight_point on the same hypotheses
    iface = jdrv.get_interface_from_url(src)
    fx, fy, u0, v0, W, H = iface.intrinsics()
    imgs = [np.asarray(fd.img) for fd in iface.frames()]
    f0, f1 = (jdet.detect(jnp.asarray(im),
                          jdet.DetectorConfig(max_keypoints=200))
              for im in imgs)
    m = jmt.match(f0.descriptor, f0.valid, f1.descriptor, f1.valid,
                  max_dist=64)
    cam = JCam.create(fx=fx, fy=fy, u0=u0, v0=v0, width=W, height=H)
    b0 = jmt.bearing_vectors(cam, f0.xy)
    b1 = jmt.bearing_vectors(cam, f1.xy[m.idx1])
    idx = jnp.asarray(_jax_draws(m.valid[None], ttm.RANSAC_ITERS)[0])
    Es = jax.vmap(lambda i: jmt._essential_from_8(b0[i], b1[i]))(idx)
    errs = np.asarray(jax.vmap(lambda E: jmt._epipolar_error(E, b0, b1))(Es))
    inl = (errs < 1e-4) & np.asarray(m.valid)[None]
    best = int(np.argmax(inl.sum(-1)))
    assert r["inliers"] == int(inl[best].sum()) >= 8
    near = np.abs(errs[best] - 1e-4) <= 1e-3 * 1e-4   # on the threshold
    np.testing.assert_array_equal(r["mask"][~near], inl[best][~near])
    # the match image as the JAX tool draws it (cv2) for the port's matches
    i0, i1 = ((im * 255).astype(np.uint8) for im in imgs)
    vis = cv2.cvtColor(np.concatenate([i0, i1], axis=1), cv2.COLOR_GRAY2BGR)
    for i in np.nonzero(r["mask"])[0]:
        cv2.line(vis, (int(r["kp0"][i, 0]), int(r["kp0"][i, 1])),
                 (int(r["kp1"][i, 0]) + W, int(r["kp1"][i, 1])),
                 (0, 255, 0), 1)
    assert np.array_equal(cv2.imread(out_t, cv2.IMREAD_COLOR), vis)


def test_draw_line_sets_the_pixels_of_cv2_line():
    rng = np.random.RandomState(0)
    for _ in range(500):
        H, W = rng.randint(1, 50), rng.randint(1, 70)
        p0 = (int(rng.randint(0, W)), int(rng.randint(0, H)))
        p1 = (int(rng.randint(0, W)), int(rng.randint(0, H)))
        a = np.zeros((H, W, 3), np.uint8)
        b = a.copy()
        cv2.line(a, p0, p1, (0, 255, 0), 1)
        ttm.draw_line(b, p0, p1, (0, 255, 0))
        assert np.array_equal(a, b), (H, W, p0, p1)
    with pytest.raises(ValueError):
        ttm.draw_line(np.zeros((4, 4, 3), np.uint8), (0, 0), (4, 0), (1,) * 3)


def test_vocabulary_files_load_across_packages(tmp_path):
    src = "synthetic://128x96:6"
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jvbld.main(["--source", src, "--num_words", "16", "--out",
                       pj]) == 0
    built = tvbld.main(["--source", src, "--num_words", "16", "--out", pt,
                        "--device", "cpu"], log=lambda s: 0)
    for path in (pj, pt):
        d = np.load(path)
        assert sorted(d.files) == ["idf", "words"]
        assert d["words"].dtype == np.uint32 and d["words"].shape == (16, 8)
        assert d["idf"].dtype == np.float32 and d["idf"].shape == (16,)
        jv = jvb.load_vocabulary(path)
        tw, ti = tvb.vocabulary_to_numpy(tvb.load_vocabulary(path, "cpu"))
        np.testing.assert_array_equal(np.asarray(jv.words), d["words"])
        np.testing.assert_array_equal(tw, d["words"])
        np.testing.assert_array_equal(np.asarray(jv.idf), d["idf"])
        np.testing.assert_array_equal(ti, d["idf"])
    np.testing.assert_array_equal(built["words"], np.load(pt)["words"])
    # the port's scores with JAX's vocabulary against JAX's on the same
    # descriptors
    from deepfactors_tpu_torch.features import detector as tdet
    from deepfactors_tpu_torch.io import drivers as tdrv

    r = tvt.main(["--source", src, "--vocab", pj, "--device", "cpu"],
                 log=lambda s: 0)
    jv = jvb.load_vocabulary(pj)
    vecs = []
    for fd in tdrv.get_interface_from_url(src, device="cpu").frames():
        f = tdet.detect(torch.as_tensor(fd.img),
                        tdet.DetectorConfig(max_keypoints=200))
        vecs.append(jvb.bow_vector(
            jv, jnp.asarray(f.descriptor.numpy().view(np.uint32)),
            jnp.asarray(f.valid.numpy())))
    db = jnp.stack(vecs)
    S = np.stack([np.asarray(jvb.similarity(v, db, jnp.ones(len(vecs), bool)))
                  for v in vecs])
    np.testing.assert_allclose(r["bow"], np.asarray(db), atol=1e-6)
    np.testing.assert_allclose(r["S"], S, atol=1e-6)


def test_every_entry_refuses_cuda_without_a_card(tmp_path):
    from deepfactors_tpu_torch.tools import (decode_image, profile_ba,
                                             profile_dispatch, profile_event,
                                             replay_viewer, result_viewer)
    assert not torch.cuda.is_available()
    d = str(tmp_path)
    entries = [lambda: replay_viewer.main([d]),
               lambda: result_viewer.main([d]),
               lambda: decode_image.main([]),
               lambda: ttm.main([]), lambda: tvbld.main([]),
               lambda: tvt.main([]), lambda: kb.main([]),
               lambda: profile_ba.main([]), lambda: profile_dispatch.main([]),
               lambda: profile_event.main([]), lambda: tsc.main([])]
    for entry in entries:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_tools_run_as_modules():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "deepfactors_tpu_torch.tools.schur_crossover",
         "4", "--device", "cpu", "--n", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "K=  4 D=  158" in r.stdout and "crossover (host)" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "deepfactors_tpu_torch.tools.voc_test"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_profile_ba_stages_and_dispatch_probe_on_the_cpu():
    """profile_ba's stages on the bench mapper (K = 5, D = 196): the dense
    and the Schur stage solve the same system (within 1e-3 relative), and
    every stage and profile_dispatch's n0 probe run on the CPU (host clock
    only)."""
    from deepfactors_tpu_torch.tools import profile_ba, profile_dispatch

    m, pool = profile_dispatch._bench_mapper(torch.device("cpu"))
    st = dict(profile_ba.stages(m, pool, torch.device("cpu")))
    assert list(st) == ["update_depth_all (L0-2)", "photometric_batch L0",
                        "assemble", "priors+mask", "solve_damped chol(196)",
                        "solve_schur_codes", "retract+update",
                        "full gn_iteration (_run)"]
    d_dense = st["solve_damped chol(196)"]()
    d_schur = st["solve_schur_codes"]()
    assert _rel(d_schur.numpy(), d_dense.numpy()) < 1e-3
    g = st["priors+mask"]()
    assert g.H.shape == (196, 196) and torch.isfinite(g.H).all()
    out = profile_ba.main(["--device", "cpu", "--n", "1"], log=lambda s: 0)
    assert list(out) == list(st)
    assert all(t["host_ms"] > 0 and t["event_us"] is None
               for t in out.values())
    n0 = profile_dispatch.main(["n0", "--device", "cpu"], log=lambda s: 0)
    assert sorted(n0) == [0, 1, 2, 4] and len(n0[0]) == len(n0[1]) == 2
