"""Loop closure of deepfactors_tpu_torch (``loop/vocabulary.py``,
``loop/loop_detector.py`` and the frame step's loop path) against the JAX
package, on the inputs of tests/test_loop.py and test_loop_archive.py
(64x96 scenes with ~10 bright squares, 2 levels, no decoder) and rendered
room views.

What must agree, with the tolerances:
  - the vocabulary (loaded, shipped, random, trained, saved): words
    identical to the bit, idf identical;
  - ``bow_vector``: identical word assignment, with ties broken to the
    first word as ``jnp.argmin`` breaks them (duplicated words and
    descriptors equally near two words), values within 1e-7 (the L1
    normalisation sums 256 terms in another order); ``similarity`` within
    1e-6, -inf in the same rows;
  - ``verify_batch`` at C = 3 against the JAX ``_make_verify_fn`` on its
    CPU path (the vmapped XLA ``se3_step``): poses within 1e-4, inlier
    counts identical (shares within 1e-6: XLA divides by the area as a
    product with its reciprocal), errors within 1e-4 relative (or 1e-9
    absolute: a view matched with itself leaves round-off), the tolerance of
    tests/test_torch_tracker.py (the same fixed GN schedule in fp32, the
    Gram sums in another order);
  - ``detect_local_loop``, ``archive_keyframe`` (database rows and archive
    identical), and ``detect_loop`` from one state (the JAX mapper's and
    detector's, carried across): the same decision, slot, archive index
    and archived pose, the verified pose within 1e-4, every candidate row
    of the verification within the tolerances above, padded to
    ``max_candidates`` by candidate 0 in both, and the temporal guard on
    recently archived keyframes. The live and archived hits query the
    keyframe's view moved by a known sub-pixel offset (``QUERY_SHIFT``):
    an exact revisit verifies to the identity up to round-off and puts
    whole rows of correspondences on the validity test's bound, where
    the rounding of the pose decides the inlier count;
  - the frame step's probe with ``with_loop=True``: BoW similarities
    within 1e-6 (the frame's keypoints identical), the rest as the
    facade tests hold it."""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch
from test_loop import H, W, feats, scene

from deepfactors_tpu import frame_step as jfs
from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.loop import loop_detector as jld
from deepfactors_tpu.loop import vocabulary as jvb
from deepfactors_tpu.mapping.mapper import Mapper as JMapper
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu.tracking.tracker import TrackerConfig as JTC
from deepfactors_tpu_torch import frame_step as tfs
from deepfactors_tpu_torch.features import detector as tdet
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.loop import loop_detector as tld
from deepfactors_tpu_torch.loop import vocabulary as tvb
from deepfactors_tpu_torch.ops import image as tip
from deepfactors_tpu_torch.ops.kernels import sfm_gram as tsg
from deepfactors_tpu_torch.tracking.tracker import TrackerConfig as TTC

torch.set_num_threads(2)
POSE_TOL = 1e-4
ERR_RTOL = 1e-4
ERR_ATOL = 1e-9     # an exact match leaves a residual of round-off, ~1e-14
BOW_TOL = 1e-7
SIM_TOL = 1e-6
SHARE_TOL = 1e-6
# The detection tests query a view moved by a known sub-pixel offset (px),
# so that every correspondence at the verified pose lies at least
# BOUND_MARGIN px from the validity test's bound: an exact revisit puts
# whole rows on it (test_exact_revisit_lies_on_the_validity_bound).
QUERY_SHIFT = (0.45, 0.3)
BOUND_MARGIN = 0.05
VOC_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                        "voc_room256.npz")
CAM = dict(fx=80.0, fy=80.0, u0=W / 2, v0=H / 2, width=W, height=H)
LCFG = dict(active_window=1, min_similarity=0.2, min_inliers=0.3,
            iters_per_level=(4, 4))


def t_voc(jv):
    return tvb.vocabulary_from_numpy(np.asarray(jv.words), np.asarray(jv.idf),
                                     device="cpu")


def t_desc(desc):
    return torch.from_numpy(np.array(desc, np.uint32).view(np.int32))


def assert_voc_equal(tv, jv):
    words, idf = tvb.vocabulary_to_numpy(tv)
    np.testing.assert_array_equal(words, np.asarray(jv.words))
    np.testing.assert_array_equal(idf, np.asarray(jv.idf))


# --------------------------------------------------------------------------
# vocabulary
# --------------------------------------------------------------------------

def test_vocabulary_load_bits_equal():
    assert os.path.exists(VOC_PATH)
    tv = tvb.load_vocabulary(VOC_PATH, device="cpu")
    assert tv.words.dtype == torch.int32 and tv.words.shape == (256, 8)
    assert_voc_equal(tv, jvb.load_vocabulary(VOC_PATH))
    assert_voc_equal(tvb.default_vocabulary(device="cpu"),
                     jvb.default_vocabulary())
    assert_voc_equal(tvb.random_vocabulary(64, device="cpu"),
                     jvb.random_vocabulary(64))


def test_train_save_vocabulary_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    descs = rng.randint(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    descs[:5, 0] = 0xFFFFFFFF        # top bits set
    jv = jvb.train_vocabulary(descs, num_words=16, iters=3)
    tv = tvb.train_vocabulary(descs, num_words=16, iters=3, device="cpu")
    assert_voc_equal(tv, jv)
    # int32 words holding the same bits train the same vocabulary
    assert_voc_equal(tvb.train_vocabulary(descs.view(np.int32), num_words=16,
                                          iters=3, device="cpu"), jv)
    path = str(tmp_path / "voc.npz")
    tvb.save_vocabulary(path, tv)
    assert_voc_equal(tv, jvb.load_vocabulary(path))


def _tie_inputs():
    """Descriptors that tie between words: exact copies of a word that is
    duplicated twice, and words one bit away from two words at once."""
    rng = np.random.RandomState(5)
    words = rng.randint(0, 2**32, (32, 8), dtype=np.uint64).astype(np.uint32)
    words[7] = words[3]
    words[20] = words[3]
    # 5 and 9 two bits apart, 12 and 30 too (in the top bits, the sign of
    # the int32 words)
    words[9, 0] = words[5, 0] ^ np.uint32(0b11)
    words[30, 0] = words[12, 0] ^ np.uint32(0b11 << 30)
    descs = rng.randint(0, 2**32, (40, 8), dtype=np.uint64).astype(np.uint32)
    descs[0:6] = words[3]                        # 0 from 3, 7 and 20
    descs[6:12] = words[5]
    descs[6:12, 0] ^= np.uint32(0b01)            # 1 from 5 and from 9
    descs[12:16] = words[12]
    descs[12:16, 0] ^= np.uint32(0b10 << 30)     # 1 from 12 and from 30
    valid = rng.rand(40) > 0.2
    valid[:16] = True
    idf = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    return words, idf, descs, valid


def test_bow_vector_ties_break_to_the_first_word():
    words, idf, descs, valid = _tie_inputs()
    jv = jvb.Vocabulary(jnp.asarray(words), jnp.asarray(idf))
    vj = np.asarray(jvb.bow_vector(jv, jnp.asarray(descs), jnp.asarray(valid)))
    vt = tvb.bow_vector(tvb.vocabulary_from_numpy(words, idf, "cpu"),
                        t_desc(descs), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(vt > 0, vj > 0)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=BOW_TOL)
    # the ties went to the first word in both
    assert vt[3] > 0 and vt[7] == 0 and vt[20] == 0
    assert vt[5] > 0 and vt[9] == 0 and vt[12] > 0 and vt[30] == 0
    assert abs(vt.sum() - 1.0) < 1e-6


def test_similarity_matches_jax():
    rng = np.random.RandomState(2)
    db = rng.rand(12, 256).astype(np.float32)
    db /= db.sum(axis=1, keepdims=True)
    v = db[3] + 0.01 * rng.rand(256).astype(np.float32)
    v /= v.sum()
    ok = rng.rand(12) > 0.3
    ok[3] = True
    sj = np.asarray(jvb.similarity(jnp.asarray(v), jnp.asarray(db),
                                   jnp.asarray(ok)))
    st = tvb.similarity(torch.from_numpy(v), torch.from_numpy(db),
                        torch.from_numpy(ok)).numpy()
    np.testing.assert_array_equal(np.isinf(st), ~ok)
    np.testing.assert_allclose(st[ok], sj[ok], atol=SIM_TOL)
    assert np.argmax(st) == 3


# --------------------------------------------------------------------------
# batched dense verification
# --------------------------------------------------------------------------

def _assert_packed_close(pt, pj):
    np.testing.assert_allclose(pt[:, :7], pj[:, :7], atol=POSE_TOL)
    # the same inlier counts: a share apart by one count differs by
    # 1/area >= 6e-5; XLA divides by the area as a product with its
    # reciprocal, one rounding apart from the port's division
    np.testing.assert_allclose(pt[:, 7], pj[:, 7], rtol=0, atol=SHARE_TOL)
    np.testing.assert_allclose(pt[:, 8], pj[:, 8], rtol=ERR_RTOL,
                               atol=ERR_ATOL)


def test_verify_batch_c3_matches_jax_cpu_path():
    """Three rendered keyframe views with their true depth, the current
    frame a fourth view; each candidate starts from its true relative pose
    perturbed."""
    kw = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    cam = JCam.create(**kw)
    room = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)
    views = [jsynth.render_aa(room, cam, poses[i], H, W) for i in (0, 2, 4, 3)]
    imgs = np.stack([np.array(v[0]) for v in views[:3]])
    dpts = np.stack([np.array(v[1]) for v in views[:3]])
    cur = np.array(views[3][0])
    init = [jse3.retract(jse3.mul(jse3.inverse(poses[3]), poses[i]),
                         jnp.asarray(d, jnp.float32))
            for i, d in zip((0, 2, 4), ([0.01, -0.01, 0.02, 0.01, 0.01, 0.0],
                                        [-0.02, 0.0, 0.01, 0.0, -0.01, 0.01],
                                        [0.0, 0.02, -0.01, -0.01, 0.0, 0.01]))]
    pq = np.stack([np.asarray(p.q) for p in init])
    pt = np.stack([np.asarray(p.t) for p in init])
    cfg = dict(iters_per_level=(6, 4), huber_delta=0.3)
    jp = jip.build_pyramid(jnp.asarray(cur), 2)
    jfn = jld._make_verify_fn(jld.LoopConfig(**cfg), cam, 2)
    pj = np.asarray(jfn(
        tuple(jax_vmap_pyr(imgs)), tuple(jax_vmap_pyr(dpts)), tuple(jp),
        tuple(jip.build_gradient_pyramid(jp)), jnp.asarray(pq),
        jnp.asarray(pt)))
    tp = tip.build_pyramid(torch.from_numpy(cur), 2)
    tfn = tld._make_verify_fn(tld.LoopConfig(**cfg), TCam.create(**kw), 2)
    before = dict(tsg.LAUNCHES)
    pt_ = tfn(tip.build_pyramid(torch.from_numpy(imgs), 2),
              tip.build_pyramid(torch.from_numpy(dpts), 2), tp,
              tip.build_gradient_pyramid(tp), torch.from_numpy(pq),
              torch.from_numpy(pt)).numpy()
    assert tsg.LAUNCHES == before          # CPU tensors: the plain twin
    assert pt_.shape == (3, 9)
    _assert_packed_close(pt_, pj)
    assert (pj[:, 7] > 0.5).all()           # every candidate verified


def jax_vmap_pyr(stack):
    import jax
    return jax.vmap(lambda im: tuple(jip.build_pyramid(im, 2)))(
        jnp.asarray(stack))


# --------------------------------------------------------------------------
# the detector, from one state
# --------------------------------------------------------------------------

def _state_view(jstate):
    """The parts of the JAX map state the port's detector reads, as CPU
    tensors."""
    c = lambda a: torch.from_numpy(np.array(a))
    lv = jstate.levels[0]
    return SimpleNamespace(
        levels=(SimpleNamespace(img=c(lv.img), dpt=c(lv.dpt)),),
        pose=TSE3(c(jstate.pose.q), c(jstate.pose.t)))


def _detectors(archive_cap, lcfg=LCFG, n_scenes=3):
    """A JAX mapper over scenes 1.. (test_loop.py), both detectors with the
    keyframes' BoW rows; the port's state carried across from the JAX
    detector."""
    jcam = JCam.create(**CAM)
    mcfg = JMC(max_keyframes=6, max_frames=1, max_factors=8, code_size=4,
               height=H, width=W, pyramid_levels=2, pho_iters=(2, 2),
               use_schur=False)
    m = JMapper(mcfg, jcam, decoder=None)
    imgs = [scene(i + 1) for i in range(n_scenes)]
    m.init_two_frames(imgs[0], imgs[1])
    for im in imgs[2:]:
        m.enqueue_keyframe(im, jse3.identity())
    jd = jld.LoopDetector(jld.LoopConfig(**lcfg), jcam, levels=2,
                          max_keyframes=6, archive_cap=archive_cap)
    td = tld.LoopDetector(tld.LoopConfig(**lcfg), TCam.create(**CAM),
                          levels=2, max_keyframes=6, voc=t_voc(jd.voc),
                          archive_cap=archive_cap, device="cpu")
    for i, s in enumerate(m.kf_slots):
        f = feats(imgs[i])
        jd.add_keyframe(s, f.descriptor, f.valid)
        td.add_keyframe(s, t_desc(f.descriptor),
                        torch.from_numpy(np.array(f.valid)))
    np.testing.assert_allclose(td.db.numpy(), np.asarray(jd.db), atol=BOW_TOL)
    tld.loop_detector_from_numpy(td, **tld.loop_detector_to_numpy(jd))
    return m, jd, td, imgs


def _query(img):
    f = feats(img)
    jp = jip.build_pyramid(jnp.asarray(img), 2)
    tp = tip.build_pyramid(torch.from_numpy(img), 2)
    return (dict(desc=f.descriptor, valid=f.valid, pyr=jp,
                 grad=jip.build_gradient_pyramid(jp)),
            dict(desc=t_desc(f.descriptor),
                 valid=torch.from_numpy(np.array(f.valid)), pyr=tp,
                 grad=tip.build_gradient_pyramid(tp)))


def _logged(det_, sink, to_np):
    verify = det_._verify

    def fn(*a):
        out = verify(*a)
        sink.append(to_np(out))
        return out

    det_._verify = fn


def _detect_both(m, jd, td, img, next_kid=None, sims=None):
    qj, qt = _query(img)
    vj, vt = [], []
    _logged(jd, vj, np.asarray)
    _logged(td, vt, lambda x: x.numpy())
    rj = jd.detect_loop(qj["desc"], qj["valid"], qj["pyr"], qj["grad"],
                        jse3.identity(), m.state, m.kf_slots,
                        sims_np=sims, next_kid=next_kid)
    rt = td.detect_loop(qt["desc"], qt["valid"], qt["pyr"], qt["grad"],
                        TSE3(np.array([1.0, 0, 0, 0], np.float32),
                             np.zeros(3, np.float32)),
                        _state_view(m.state), m.kf_slots,
                        sims_np=sims, next_kid=next_kid)
    return rj, rt, vj, vt


def _assert_results_equal(rt, rj):
    assert (rt.detected, rt.slot, rt.archived_idx) == \
        (rj.detected, rj.slot, rj.archived_idx)
    if rj.detected:
        np.testing.assert_allclose(rt.pose_cand_cur.q.numpy(),
                                   np.asarray(rj.pose_cand_cur.q), atol=POSE_TOL)
        np.testing.assert_allclose(rt.pose_cand_cur.t.numpy(),
                                   np.asarray(rj.pose_cand_cur.t), atol=POSE_TOL)
    if rj.arch_pose_w is not None:
        np.testing.assert_array_equal(rt.arch_pose_w.q,
                                      np.asarray(rj.arch_pose_w.q))
        np.testing.assert_array_equal(rt.arch_pose_w.t,
                                      np.asarray(rj.arch_pose_w.t))


def test_detect_local_loop_matches_jax():
    ld_j = jld.LoopDetector(jld.LoopConfig(active_window=2, max_dist=5.0),
                            JCam.create(**CAM), levels=2, max_keyframes=8)
    ld_t = tld.LoopDetector(tld.LoopConfig(active_window=2, max_dist=5.0),
                            TCam.create(**CAM), levels=2, max_keyframes=8,
                            device="cpu")
    t = np.zeros((8, 3), np.float32)
    t[:5, 0] = np.arange(5) * 0.5
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (8, 1))
    active = np.array([True] * 5 + [False] * 3)
    for cur_t, order, cur_kf in (([0.1, 0, 0], [0, 1, 2, 3, 4], -1),
                                 ([1.1, 0, 0], [0, 1, 2, 3, 4], 2),
                                 ([0.1, 0, 0], [1, 2, 3, 4, 0], -1),
                                 ([9.0, 0, 0], [0, 1, 2, 3, 4], -1)):
        cj = JSE3(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray(cur_t, jnp.float32))
        sj = ld_j.detect_local_loop(cj, JSE3(jnp.asarray(q), jnp.asarray(t)),
                                    active, order, cur_kf)
        st = ld_t.detect_local_loop(
            TSE3(np.array([1.0, 0, 0, 0], np.float32),
                 np.array(cur_t, np.float32)),
            TSE3(torch.from_numpy(q), torch.from_numpy(t)), active, order,
            cur_kf)
        assert st == sj
    assert st == -1 and sj == -1            # 9 m away: nothing near enough


def _shifted(img, dx=QUERY_SHIFT[0], dy=QUERY_SHIFT[1]):
    """img resampled bilinearly at (x + dx, y + dy), the last row and column
    clamped: the view of a camera moved by a known sub-pixel offset over the
    keyframes' fronto-parallel plane (their depth is 2 everywhere)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    x, y = np.clip(xs + dx, 0, W - 1), np.clip(ys + dy, 0, H - 1)
    x0 = np.minimum(np.floor(x).astype(int), W - 2)
    y0 = np.minimum(np.floor(y).astype(int), H - 2)
    ax, ay = x - x0, y - y0
    out = ((1 - ay) * ((1 - ax) * img[y0, x0] + ax * img[y0, x0 + 1])
           + ay * ((1 - ax) * img[y0 + 1, x0] + ax * img[y0 + 1, x0 + 1]))
    return out.astype(np.float32)


def _bound_margins(packed, dpt):
    """Distance in pixels, over every pixel of a candidate's level-0 depth
    dpt [H, W], from its correspondence at each verified pose (the rows of
    packed [C, 9]) to the nearest edge of the validity test (border 1), as
    each package computes the correspondence: [2, C]."""
    from deepfactors_tpu.geometry import warping as jwarp
    from deepfactors_tpu_torch.geometry import warping as twarp
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pix0 = np.stack([xs, ys], -1)
    out = np.zeros((2, len(packed)))
    for c, row in enumerate(packed):
        q, t = row[:4].astype(np.float32), row[4:7].astype(np.float32)
        pj = np.asarray(jwarp.find_correspondence(
            jnp.asarray(pix0), jnp.asarray(dpt), JCam.create(**CAM),
            JSE3(jnp.asarray(q), jnp.asarray(t))).pix1)
        pt = twarp.find_correspondence(
            torch.from_numpy(pix0), torch.from_numpy(dpt), TCam.create(**CAM),
            TSE3(torch.from_numpy(q), torch.from_numpy(t))).pix1.numpy()
        for k, p in enumerate((pj, pt)):
            out[k, c] = min(np.abs(p[..., 0][..., None] - [1.0, W - 1.0]).min(),
                            np.abs(p[..., 1][..., None] - [1.0, H - 1.0]).min())
    return out


def test_detect_loop_live_hit_padded_batch():
    """Scene 1 seen again from a camera moved by QUERY_SHIFT: matches
    keyframe slot 0 outside the window of one. The verification batch is
    padded to max_candidates (10) by candidate 0 in both packages."""
    m, jd, td, imgs = _detectors(archive_cap=4)
    rj, rt, vj, vt = _detect_both(m, jd, td, _shifted(imgs[0]))
    assert rj.detected and rj.slot == m.kf_slots[0]
    _assert_results_equal(rt, rj)
    assert len(vj) == len(vt) == 1
    assert vt[0].shape == vj[0].shape == (10, 9)
    dpt0 = np.array(m.state.levels[0].dpt[m.kf_slots[0]])
    assert _bound_margins(vj[0][:1], dpt0).min() > BOUND_MARGIN
    _assert_packed_close(vt[0], vj[0])
    np.testing.assert_array_equal(vt[0][-1], vt[0][0])   # padding = cand 0
    assert float(np.linalg.norm(rt.pose_cand_cur.t.numpy())) < 0.05


def test_exact_revisit_lies_on_the_validity_bound():
    """Why the two detection tests query a shifted view: the view keyframe
    slot 0 was built from verifies to the identity up to round-off, and then
    every correspondence of the last row and column lies within round-off
    of the validity test's bound (under 1e-4 px here), in both packages:
    which side each falls on is decided by the rounding of the pose, so
    the inlier counts of the two packages may part by whole pixels."""
    m, jd, td, imgs = _detectors(archive_cap=4)
    rj, rt, vj, vt = _detect_both(m, jd, td, imgs[0])
    assert rj.detected and rt.detected
    dpt0 = np.array(m.state.levels[0].dpt[m.kf_slots[0]])
    margins = np.concatenate([_bound_margins(vj[0][:1], dpt0),
                              _bound_margins(vt[0][:1], dpt0)])
    assert margins.max() < 1e-4


def test_detect_loop_archived_hit():
    """Keyframe 0 archived (as an eviction would), then queried from a
    camera moved by QUERY_SHIFT: the archive row matches, with its world
    pose."""
    m, jd, td, imgs = _detectors(archive_cap=4)
    s0 = m.kf_slots[0]
    aj = jd.archive_keyframe(s0, kf_id=0, state=m.state)
    at = td.archive_keyframe(s0, kf_id=0, state=_state_view(m.state))
    assert aj == at == 0
    got = tld.loop_detector_to_numpy(td)
    for k, v in tld.loop_detector_to_numpy(jd).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not got["db_valid"][s0] and got["db_valid"][6]
    rj, rt, vj, vt = _detect_both(m, jd, td, _shifted(imgs[0]),
                                  next_kid=100)
    assert rj.detected and rj.slot == -1 and rj.archived_idx == 0
    _assert_results_equal(rt, rj)
    dpt0 = np.array(m.state.levels[0].dpt[s0])
    assert _bound_margins(vj[0][:1], dpt0).min() > BOUND_MARGIN
    _assert_packed_close(vt[0], vj[0])


def test_detect_loop_temporal_guard():
    """A keyframe archived within the active window of the next id is not
    a revisit: it is excluded in both, and nothing else passes."""
    lcfg = dict(LCFG, active_window=3)
    m, jd, td, imgs = _detectors(archive_cap=4, lcfg=lcfg, n_scenes=2)
    jd.archive_keyframe(m.kf_slots[0], kf_id=5, state=m.state)
    td.archive_keyframe(m.kf_slots[0], kf_id=5, state=_state_view(m.state))
    rj, rt, vj, vt = _detect_both(m, jd, td, imgs[0], next_kid=6)
    assert rj.archived_idx == rt.archived_idx == -1
    _assert_results_equal(rt, rj)
    assert len(vj) == len(vt)
    # the same query a keyframe later passes the guard in both
    rj, rt, _, _ = _detect_both(m, jd, td, imgs[0], next_kid=9)
    assert rj.archived_idx == 0
    _assert_results_equal(rt, rj)


def test_detect_loop_given_similarities_and_none_above_threshold():
    """The probe's similarities, given as ``sims_np`` (length K + A):
    below min_similarity nothing is verified; one row above it is."""
    m, jd, td, imgs = _detectors(archive_cap=4)
    sims = np.full(10, 0.1, np.float32)
    rj, rt, vj, vt = _detect_both(m, jd, td, imgs[0], sims=sims)
    assert not rj.detected and not rt.detected and vj == vt == []
    sims[m.kf_slots[0]] = 0.9
    rj, rt, vj, vt = _detect_both(m, jd, td, imgs[0], sims=sims)
    assert rj.detected
    _assert_results_equal(rt, rj)


def test_detector_state_round_trip():
    _, jd, td, _ = _detectors(archive_cap=4)
    a = tld.loop_detector_to_numpy(td)
    td2 = tld.loop_detector_from_numpy(
        tld.LoopDetector(tld.LoopConfig(**LCFG), TCam.create(**CAM), 2, 6,
                         voc=td.voc, archive_cap=4, device="cpu"), **a)
    for k, v in tld.loop_detector_to_numpy(td2).items():
        np.testing.assert_array_equal(v, a[k], err_msg=k)
    assert td2.db_valid.dtype == torch.bool
    td2.reset()
    assert not td2.db_valid.any() and (td2.arch_ids == -1).all()


# --------------------------------------------------------------------------
# the frame step with loop closure
# --------------------------------------------------------------------------

def test_frame_step_probe_sims_with_loop():
    """A rendered 96x128 room view tracked against a keyframe pool of two
    views, with a loop database of K + A rows (some valid): the probe's
    similarities within 1e-6, the pose as the tracker tests hold it."""
    Hf, Wf, K, A, L = 96, 128, 4, 3, 3
    kw = dict(fx=110.0, fy=110.0, u0=Wf / 2, v0=Hf / 2, width=Wf, height=Hf)
    room = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)
    cam = JCam.create(**kw)
    views = [jsynth.render_aa(room, cam, poses[i], Hf, Wf) for i in (0, 2, 3)]
    kf_imgs = np.zeros((K, Hf, Wf), np.float32)
    kf_dpts = np.ones((K, Hf, Wf), np.float32)
    for s, v in enumerate(views[:2]):
        kf_imgs[s], kf_dpts[s] = np.array(v[0]), np.array(v[1])
    rel = [jse3.mul(jse3.inverse(poses[0]), p) for p in poses]
    kq = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    kt = np.zeros((K, 3), np.float32)
    for s, i in enumerate((0, 2)):
        kq[s], kt[s] = np.asarray(rel[i].q), np.asarray(rel[i].t)
    fq = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    ft = np.zeros((2, 3), np.float32)
    voc = jvb.default_vocabulary()
    rng = np.random.RandomState(4)
    db = rng.rand(K + A, 256).astype(np.float32)
    db /= db.sum(axis=1, keepdims=True)
    ok = np.array([True, True, False, False, True, False, True])
    img = np.array(views[2][0])
    prev = (np.asarray(rel[2].q), np.asarray(rel[2].t))
    det_cfg = dict(max_keypoints=128)
    jcfg = JTC(pyramid_levels=L, iterations_per_level=(10, 5, 4))
    from deepfactors_tpu.features import detector as jdet
    jf = jfs.build_frame_fn(jcfg, cam, L, with_loop=True,
                            det_cfg=jdet.DetectorConfig(**det_cfg))
    oj = jf(img, jax_stack_pyr(kf_imgs, L), jax_stack_pyr(kf_dpts, L),
            kq, kt, fq, ft, jnp.asarray(1, jnp.int32), *prev, *prev,
            voc.words, voc.idf, jnp.asarray(db), jnp.asarray(ok))
    tf = tfs.build_frame_fn(TTC(pyramid_levels=L,
                                iterations_per_level=(10, 5, 4)),
                            TCam.create(**kw), L, with_loop=True,
                            det_cfg=tdet.DetectorConfig(**det_cfg))
    c = torch.from_numpy
    ot = tf(img, tuple(tip.build_pyramid(c(kf_imgs), L)),
            tuple(tip.build_pyramid(c(kf_dpts), L)), c(kq), c(kt), c(fq),
            c(ft), 1, c(prev[0]), c(prev[1]), c(prev[0]), c(prev[1]),
            t_voc(voc), c(db), c(ok))
    off, n = tfs.probe_layout(K, 2, K + A)
    assert (off, n) == jfs.probe_layout(K, 2, K + A)
    pj, pt = np.asarray(oj.probe), ot.probe.numpy()
    assert pt.shape == (n,)
    vj, vt = np.asarray(oj.feat.valid), ot.feat.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() >= 20
    np.testing.assert_array_equal(ot.feat.descriptor.numpy().view(np.uint32)[vt],
                                  np.asarray(oj.feat.descriptor)[vj])
    np.testing.assert_allclose(ot.bow_v.numpy(), np.asarray(oj.bow_v),
                               atol=BOW_TOL)
    s = slice(*off["sims"])
    np.testing.assert_array_equal(np.isinf(pt[s]), ~ok)
    np.testing.assert_allclose(pt[s][ok], pj[s][ok], atol=SIM_TOL)
    np.testing.assert_allclose(pt[:7], pj[:7], atol=POSE_TOL)
    tail = slice(*off["tail"])
    np.testing.assert_allclose(pt[tail][1], pj[tail][1], atol=1e-6)


def jax_stack_pyr(stack, L):
    import jax
    return jax.vmap(lambda im: tuple(jip.build_pyramid(im, L)))(
        jnp.asarray(stack))
