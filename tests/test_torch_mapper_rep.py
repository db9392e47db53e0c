"""The reprojection factors of deepfactors_tpu_torch.mapping.mapper against
the JAX Mapper: keyframe feature pools, match + RANSAC into the rep pool,
mapping with rep factors assembled into every GN iteration, eviction of
rep factors, and the ``dump_state`` rep lists.

The sequence is a 48x64 view of a corner-rich textured plane, translated
3 px per frame (a camera moving sideways in front of a fronto-parallel
plane: the image moves rigidly). The synthetic rooms of the other tests
hold too few Harris corners at 48x64 (about 10 a frame, under the 16-pixel
descriptor border) for 8 matches to survive; this texture gives about 20
keypoints and 17 matches a pair. The decoder is the small random-init one
(base_ch 8, CS 4), carried across by ``params_from_jax``; the window is 4
keyframes with 2 back-connections, so the run evicts twice.

The RANSAC draws: the port's mapper takes them from its ``ransac_draw``
hook, which this test replaces by a replay of the JAX mapper's key chain
(PRNGKey(42), one split per keyframe event, split(key, 2n), one
``categorical`` draw per direction). With it both packages see the same
hypotheses.

What must agree, with the tolerances:
  - the keyframe build's keypoint pools: xy and validity identical,
    descriptors identical to the bit (both sample the same bilinear
    values; a bit could flip only where two samples tie within rounding,
    and none does here);
  - after every keyframe event, the rep works registered and the rep pool
    (src, dst, active, kp0, kp1, mvalid of every live slot): identical;
  - after the mapping that follows each event: keyframe poses and codes
    within 5e-4, the tolerance of tests/test_torch_mapper.py (the decoders
    differ by bf16 rounding, ~1.5e-4 of depth);
  - the evictions: the same victims, and the same rep factors dropped with
    them;
  - ``dump_state``'s rep list: identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params

from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.mapping.mapper import Mapper as JMapper
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.models.decoder import Decoder as JDec
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu_torch.features import detector as tdet
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping.mapper import Mapper as TMapper
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.models.decoder import Decoder as TDec
from deepfactors_tpu_torch.models.decoder import NetworkConfig as TNC

torch.set_num_threads(2)
H, W, CS = 48, 64, 4
FX, DEPTH, STEP = 55.0, 2.0, 3      # focal length, plane depth, px per frame
TOL = 5e-4
KF_FRAMES = (4, 6, 8, 10)           # keyframes after the bootstrap on 0 and 2


def textured_strip(n_frames, step=STEP, spacing=6, size=3, seed=9):
    """Frames of a textured plane seen by a camera translating along x:
    frame i is the strip shifted by step * i pixels."""
    rng = np.random.RandomState(seed)
    Ws = W + step * n_frames
    ys, xs = np.mgrid[0:H, 0:Ws].astype(np.float32)
    img = 0.3 + 0.15 * np.sin(xs / 7) * np.cos(ys / 5)
    for cy in range(2, H - 2, spacing):
        for cx in range(2, Ws - 2, spacing):
            img[cy:cy + size, cx:cx + size] = rng.uniform(0.5, 1.0)
    return [img[:, step * i:step * i + W].astype(np.float32)
            for i in range(n_frames)]


def strip_pose(SE, i):
    """Camera-to-world pose of frame i (x translation of the plane's image
    shift at its depth)."""
    return SE(np.array([1.0, 0, 0, 0], np.float32),
              np.array([STEP * i * DEPTH / FX, 0, 0], np.float32))


class JaxKeyChain:
    """The JAX mapper's key chain, replayed for both of the port mapper's
    draw hooks: ``ransac_draw`` (the instance itself) and ``geo_draw``
    (its ``geo`` method). The chain starts at PRNGKey(42) and splits once
    per draw, in the order the JAX mapper draws
    (deepfactors_tpu/mapping/mapper.py ``_next_key``): at a keyframe event
    the RANSAC draw of all back-connections first, then one geometric
    sample per connection, then the stochastic resamples in bookkeeping
    order. The port's mapper calls its hooks in that order, so one chain
    serves both. A RANSAC draw splits its key into one key per direction,
    and each direction draws ``categorical`` over logits 0 (valid match) or
    -1e9 (``_rep_pair_fn``); a geometric draw is
    ``features/sampler.sample_uniform_pixels`` of its key."""

    def __init__(self):
        self.key = jax.random.PRNGKey(42)
        self.calls = 0
        self.geo_calls = 0

    def _next_key(self):
        self.key, k = jax.random.split(self.key)
        return k

    def __call__(self, valids, iterations):
        self.calls += 1
        k = self._next_key()
        v = np.asarray(valids.cpu())
        ks = jax.random.split(k, v.shape[0])
        return np.stack([np.asarray(jax.random.categorical(
            ks[d], jnp.where(jnp.asarray(v[d]), 0.0, -1e9),
            shape=(iterations, 8))) for d in range(v.shape[0])])

    def geo(self, n, width, height):
        from deepfactors_tpu.features.sampler import sample_uniform_pixels

        self.geo_calls += 1
        return np.asarray(sample_uniform_pixels(self._next_key(), n, width,
                                                height))


def config(MC):
    return MC(max_keyframes=4, max_frames=2, max_factors=16, code_size=CS,
              height=H, width=W, pyramid_levels=2, pho_iters=(4, 8),
              max_back_connections=2, use_reprojection=True,
              max_keypoints=128)


def _snap(m):
    p = m.keyframe_poses()
    return dict(q=np.array(p.q), t=np.array(p.t), c=np.array(m.keyframe_codes()),
                slots=list(m.kf_slots))


def _rep_state(m):
    p = m.rep_pool
    live = np.nonzero(p.active)[0]
    return dict(
        works=[w.name for w in m.work.work if w.name.startswith("rep")],
        live=[(int(i), int(p.src[i]), int(p.dst[i])) for i in live],
        kp0=p.kp0[live].copy(), kp1=p.kp1[live].copy(),
        mvalid=p.mvalid[live].copy())


def _drive(m, SE, frames, evicted):
    out = {"events": []}
    m.evict_callback = lambda slot, kid: evicted.append((slot, kid))

    def settle():
        while m.has_work():
            m.mapping_run()
        m.update_map()

    s0, s1 = m.init_two_frames(frames[0], frames[2], pose1=strip_pose(SE, 2))
    m.update_map()
    st = m.state
    out["kp"] = dict(xy=np.array(st.kp_xy), valid=np.array(st.kp_valid),
                     desc=np.array(st.kp_desc).view(np.uint32))
    out["init"] = _snap(m)
    for i in KF_FRAMES:
        m.protected_slots = set(m.kf_slots[-2:])
        p = strip_pose(SE, i)
        before = _rep_state(m)["live"]
        m.enqueue_keyframe(frames[i], SE(p.q, p.t + np.array(
            [0.01, -0.005, 0.005], np.float32)))
        # the new works take their pool slots at the next bookkeeping, so
        # the pool now differs from ``before`` by the eviction alone
        ev = {"works": _rep_state(m)["works"], "evicted": list(evicted),
              "dropped": sorted(set(before) - set(_rep_state(m)["live"]))}
        settle()
        ev.update(rep=_rep_state(m), post=_snap(m))
        out["events"].append(ev)
    out["dump"] = m.dump_state()["rep_factors"]
    return out


@pytest.fixture(scope="module")
def runs():
    frames = textured_strip(KF_FRAMES[-1] + 1)
    kw = dict(fx=FX, fy=FX, u0=W / 2, v0=H / 2, width=W, height=H)
    ncfg = dict(code_size=CS, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    jm = JMapper(config(JMC), JCam.create(**kw),
                 decoder=JDec(JNC(**ncfg), params=params))
    tm = TMapper(config(TMC), TCam.create(**kw),
                 decoder=TDec(TNC(**ncfg), params=params, device="cpu"),
                 device="cpu")
    chain = JaxKeyChain()
    tm.ransac_draw = chain
    ev_j, ev_t = [], []
    out = dict(jax=_drive(jm, JSE3, frames, ev_j),
               torch=_drive(tm, TSE3, frames, ev_t))
    out["chain_calls"] = chain.calls
    out["rep_stats"] = dict(tm.rep_stats)
    return out


def test_keyframe_build_keypoint_pools_identical(runs):
    a, b = runs["torch"]["kp"], runs["jax"]["kp"]
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert a["valid"][:2].sum(axis=1).min() >= 15
    v = b["valid"]
    np.testing.assert_array_equal(a["xy"][v], b["xy"][v])
    np.testing.assert_array_equal(a["desc"][v], b["desc"][v])


@pytest.mark.parametrize("i", range(len(KF_FRAMES)))
def test_rep_pool_after_event_identical(runs, i):
    a, b = runs["torch"]["events"][i], runs["jax"]["events"][i]
    assert a["works"] == b["works"]
    assert a["works"], "the event registered no rep work"
    assert a["rep"]["live"] == b["rep"]["live"]
    for k in ("kp0", "kp1", "mvalid"):
        np.testing.assert_array_equal(a["rep"][k], b["rep"][k])


@pytest.mark.parametrize("stage", ["init"] + [f"event{i}" for i in
                                              range(len(KF_FRAMES))])
def test_poses_and_codes_match_jax(runs, stage):
    if stage == "init":
        a, b = runs["torch"]["init"], runs["jax"]["init"]
    else:
        i = int(stage[5:])
        a = runs["torch"]["events"][i]["post"]
        b = runs["jax"]["events"][i]["post"]
    assert a["slots"] == b["slots"]
    for k in ("q", "t", "c"):
        np.testing.assert_allclose(a[k], b[k], atol=TOL)


def test_rep_factors_assembled_and_draws_replayed(runs):
    """Every keyframe event matched once (one hook call), and the GN
    iterations assembled rep factors."""
    assert runs["chain_calls"] == len(KF_FRAMES)
    assert runs["rep_stats"]["iterations"] > 0
    assert runs["rep_stats"]["factor_terms"] >= runs["rep_stats"]["iterations"]


def test_eviction_drops_the_same_rep_factors(runs):
    """The two evictions (at the third and fourth events) drop the same rep
    factors in both packages: every live one touching the victim's slot,
    and no other."""
    a, b = runs["torch"]["events"], runs["jax"]["events"]
    assert [e["evicted"] for e in a] == [e["evicted"] for e in b]
    assert len(a[-1]["evicted"]) == 2
    for i, (ea, eb) in enumerate(zip(a, b)):
        assert ea["dropped"] == eb["dropped"]
        new = ea["evicted"][len(a[i - 1]["evicted"]) if i else 0:]
        if not new:
            assert ea["dropped"] == []
            continue
        victim = new[0][0]
        assert ea["dropped"], "the eviction dropped no rep factor"
        assert all(victim in (s, d) for _, s, d in ea["dropped"])
        assert all(victim not in (s, d) for _, s, d in a[i - 1]["rep"]["live"]
                   if (_, s, d) not in ea["dropped"])


def test_dump_state_rep_lists_identical(runs):
    a, b = runs["torch"]["dump"], runs["jax"]["dump"]
    assert a == b and len(a) > 0


def test_features_carry_across_both_ways():
    """features_from_numpy / features_to_numpy round-trip the JAX package's
    uint32 descriptors (top bit set included) and a rep pool."""
    from deepfactors_tpu.features import detector as jdet
    from deepfactors_tpu.mapping.mapper_pools import _empty_rep_pool

    rng = np.random.RandomState(3)
    desc = rng.randint(0, 2 ** 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    desc[0, 0] = 0xFFFFFFFF
    jf = jdet.Features(xy=rng.rand(5, 2).astype(np.float32),
                       score=rng.rand(5).astype(np.float32),
                       angle=rng.rand(5).astype(np.float32), descriptor=desc,
                       valid=rng.rand(5) > 0.5)
    tf = tdet.features_from_numpy(jf, device="cpu")
    assert tf.descriptor.dtype == torch.int32
    back = tdet.features_to_numpy(tf)
    for n in jdet.Features._fields:
        np.testing.assert_array_equal(getattr(back, n), getattr(jf, n))
    pool = _empty_rep_pool(3, 4)
    pool.kp0[1] = 2.5
    pool.active[1] = True
    tp = tdet.features_from_numpy(pool, device="cpu")
    assert type(tp).__module__.startswith("deepfactors_tpu_torch")
    for n in pool._fields:
        np.testing.assert_array_equal(getattr(tdet.features_to_numpy(tp), n),
                                      getattr(pool, n))


# --------------------------------------------------------------------------
# loop-closure links and priors (Mapper.enqueue_link, add_loop_prior)
# --------------------------------------------------------------------------

def _link_pair(use_reprojection):
    """Both mappers after the bootstrap on frames 0 and 1 and keyframes at
    frames 2 and 3 (two back-connections: the newest keyframe is not
    connected to the first, 9 px away), settled; the RANSAC draws
    replayed."""
    frames = textured_strip(4)
    kw = dict(fx=FX, fy=FX, u0=W / 2, v0=H / 2, width=W, height=H)
    ncfg = dict(code_size=CS, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    cfg = lambda MC: config(MC)._replace(max_keyframes=6,
                                         use_reprojection=use_reprojection)
    jm = JMapper(cfg(JMC), JCam.create(**kw),
                 decoder=JDec(JNC(**ncfg), params=params))
    tm = TMapper(cfg(TMC), TCam.create(**kw),
                 decoder=TDec(TNC(**ncfg), params=params, device="cpu"),
                 device="cpu")
    tm.ransac_draw = JaxKeyChain()
    for m, SE in ((jm, JSE3), (tm, TSE3)):
        m.init_two_frames(frames[0], frames[1], pose1=strip_pose(SE, 1))
        for i in (2, 3):
            m.enqueue_keyframe(frames[i], strip_pose(SE, i))
            while m.has_work():
                m.mapping_run()
            m.update_map()
    return jm, tm


def _works(m):
    return [(w.name, tuple(w.iters), w.remove_after) for w in m.work.work]


def _settle(m):
    while m.has_work():
        m.mapping_run()
    m.update_map()


@pytest.mark.parametrize("kind", ["photo", "rep", "rep_without_reprojection"])
def test_enqueue_link_matches_jax(kind):
    """A loop link from the newest keyframe to the first: photometric
    (both ways, the second direction removed after its schedule), a
    reprojection link (match + RANSAC both ways into the rep pool), or
    rep=True without reprojection factors, which falls back to a
    photometric link. The works, pools and links must be identical, the
    window after the optimisation within 5e-4."""
    jm, tm = _link_pair(use_reprojection=(kind != "rep_without_reprojection"))
    a, b = tm.kf_slots[-1], tm.kf_slots[0]
    assert not any({a, b} == set(p) for _, p in tm.links_host)
    rep_before = _rep_state(tm)["live"]
    for m in (jm, tm):
        m.enqueue_link(a, b, photo=(kind == "photo"), rep=(kind != "photo"))
    assert _works(tm) == _works(jm) and _works(tm)
    assert [p for _, p in tm.links_host] == [p for _, p in jm.links_host]
    names = [w[0] for w in _works(tm)]
    if kind == "rep":
        assert any(n.startswith("rep") for n in names)
    else:
        assert not any(n.startswith("rep") for n in names)
        assert any({a, b} == set(p) for _, p in tm.links_host)
    for m in (jm, tm):
        _settle(m)
    ra, rb = _rep_state(tm), _rep_state(jm)
    assert ra["live"] == rb["live"]
    np.testing.assert_array_equal(ra["mvalid"], rb["mvalid"])
    # the matched keypoints where a match survived: a row without a valid
    # match points at an invalid keypoint, whose position is arbitrary
    # (found: 2 of 1024 rows differ, none valid)
    v = ra["mvalid"]
    for k in ("kp0", "kp1"):
        np.testing.assert_array_equal(ra[k][v], rb[k][v])
    if kind == "rep":
        assert len(ra["live"]) > len(rep_before)      # the link's factors
    sa, sb = _snap(tm), _snap(jm)
    for k in ("q", "t", "c"):
        np.testing.assert_allclose(sa[k], sb[k], atol=TOL)


def test_enqueue_link_geometric_raises():
    """``enqueue_link(geo=True)`` raised while the geometric factor was not
    ported; now it does what the JAX mapper does: with geometric factors
    off it adds no work, with them on one geometric work slot0 -> slot1 on
    points from the key chain's draw (the same points as JAX's). The geo
    link in a mapping run is held against JAX in
    tests/test_torch_mapper_geo.py."""
    kw = dict(fx=FX, fy=FX, u0=W / 2, v0=H / 2, width=W, height=H)
    for use_geo in (False, True):
        tm = TMapper(config(TMC)._replace(use_geometric=use_geo),
                     TCam.create(**kw), device="cpu")
        tm.geo_draw = JaxKeyChain().geo
        jm = JMapper(config(JMC)._replace(use_geometric=use_geo),
                     JCam.create(**kw))
        for m in (tm, jm):
            m.enqueue_link(0, 1, photo=False, geo=True)
        names = [w.name for w in tm.work.work]
        assert names == [w.name for w in jm.work.work]
        assert names == (["geo 0->1"] if use_geo else [])
        if use_geo:
            np.testing.assert_array_equal(tm.work.work[0].points,
                                          np.asarray(jm.work.work[0].points))


def test_add_loop_prior_matches_jax():
    """A loop prior of sigma 0.05 on the newest keyframe, at a target 5 cm
    off its estimate, from one estimate in both: the marginal store within
    1e-6, and after re-optimising with fresh photometric works the
    keyframe pulled toward the target in both, the window within 5e-4."""
    jm, tm = _link_pair(use_reprojection=False)
    # one estimate in both, so that the store holds the prior's arithmetic
    # alone (the prior is anchored at the keyframe's code)
    c = lambda dst, src: dst.copy_(torch.from_numpy(np.array(src)))
    for a, b in ((tm.state.pose.q, jm.state.pose.q),
                 (tm.state.pose.t, jm.state.pose.t),
                 (tm.state.code, jm.state.code)):
        c(a, b)
    s = tm.kf_slots[-1]
    t0 = np.array(jm.state.pose.t[s])
    tgt_q = np.array(jm.state.pose.q[s])
    tgt_t = t0 + np.array([0.05, 0.0, 0.0], np.float32)
    jm.add_loop_prior(s, JSE3(tgt_q, tgt_t), sigma=0.05)
    tm.add_loop_prior(s, TSE3(tgt_q, tgt_t), sigma=0.05)
    for name in tm.marginals._fields:
        np.testing.assert_allclose(
            np.array(getattr(tm.marginals, name)),
            np.array(getattr(jm.marginals, name)), atol=1e-6, err_msg=name)
    assert bool(tm.marginals.active[s])
    np.testing.assert_array_equal(np.array(tm.marginals.H[s])[:6, :6],
                                  np.eye(6, dtype=np.float32) / 0.05 ** 2)
    for m in (jm, tm):
        m._add_photo_pair(s, m.kf_slots[-2], second_removes=True)
        _settle(m)
    sa, sb = _snap(tm), _snap(jm)
    for k in ("q", "t", "c"):
        np.testing.assert_allclose(sa[k], sb[k], atol=TOL)
    assert abs(sa["t"][s][0] - tgt_t[0]) < abs(t0[0] - tgt_t[0]) * 0.5
