"""Keyframe eviction of deepfactors_tpu_torch.mapping.mapper against the JAX
Mapper: both run the 48x64, 2-level room sequence of
tests/test_torch_mapper.py with ``max_keyframes=4``, fed past the window
(seven keyframes and one one-way frame, so three evictions; the second
victim carries a marginal prior of its own, from the frame). Both mappers
get the same decoder outputs (the JAX decoder's), and before every keyframe
event the port's estimate is set to the JAX mapper's, so each event's
comparison holds that event's arithmetic alone.

After every keyframe event the two mappers must agree on: the victim and
its id, ``kf_slots``, ``kf_ids``, the live pool factors, the links, the
archived pose (1e-4), the marginal store (below), and, after the following
optimisation to an empty work list, the window's poses and codes.

Tolerances, with what this run showed. Poses and codes after the
optimisation: 5e-4, the tolerance of ROADMAP queue C (found: 9.2e-5 m
after the event that folds the one-way frame, at most 1.8e-5 m after an
eviction). The neighbours' marginal ``H`` within 1e-4 of max|H| and ``b``
within 1e-4 of max|b| (found: 6.3e-6 and 2.6e-5; max|H| is 770-3000);
anchors 1e-5. A store whose largest entry is below 1 holds only the prior
of one keyframe-frame factor, which is fp32 round-off on both sides
(tests/test_torch_mapper.py), and is not compared. The Schur-and-PSD
arithmetic itself is held at 1e-5 on a seeded well-posed system."""
import jax
import jax.numpy as jnp
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
from deepfactors_tpu.solver import nearest_psd as jpsd
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping import mapper as tmapper
from deepfactors_tpu_torch.mapping.mapper import Mapper as TMapper
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.solver import nearest_psd as tpsd

torch.set_num_threads(2)
H, W, CS, K = 48, 64, 4, 4
TOL = 5e-4            # poses and codes after the optimisation
MARG_TOL = 1e-4       # marginal H and b, as a share of their largest entry
ANCHOR_TOL = 1e-5
ARCHIVE_TOL = 1e-4
KF_FRAMES = (4, 6, 8, 10, 12)   # keyframes after the bootstrap on 0 and 2


class _JaxOutputsDecoder:
    """Hands the port's mapper the JAX decoder's own outputs, so both
    mappers start every keyframe from the same depth, Jacobian and
    predicted code: what differs afterwards is the mappers' arithmetic, not
    the two decoders' bf16 rounding (tests/test_torch_decoder.py holds
    that)."""

    def __init__(self, jdec):
        self.params = jdec.params
        self.apply = jax.jit(jdec.module.apply)

    def raw_outputs_T(self, img):
        out = self.apply(self.params, jnp.asarray(img.numpy()))
        t = lambda a: torch.from_numpy(np.array(a, np.float32))
        return dict(prx0=tuple(t(p) for p in out["prx0"]),
                    jac=tuple(t(j).permute(2, 0, 1).contiguous()
                              for j in out["jac"]),
                    stdev=tuple(t(x) for x in out["stdev"]),
                    code_pred=t(out["code_pred"]))


def _snap(m):
    p = m.keyframe_poses()
    return dict(q=np.array(p.q), t=np.array(p.t), c=np.array(m.keyframe_codes()))


def _event(m):
    pool = m.pool
    live = sorted((int(pool.src[i]), int(pool.dst[i]), bool(pool.dst_is_frame[i]),
                   int(pool.level[i]))
                  for i in range(len(pool.active)) if pool.active[i])
    mg = m.marginals
    arch = m.archived[-1] if m.archived else None
    return dict(
        slots=list(m.kf_slots), ids=dict(m.kf_ids), pool=live,
        links=sorted(tuple(pair) for _, pair in m.links_host),
        link_table=int(np.array(m.state.link_active).sum()),
        n_archived=len(m.archived),
        arch_id=None if arch is None else arch["id"],
        arch_q=None if arch is None else np.array(arch["q"]),
        arch_t=None if arch is None else np.array(arch["t"]),
        active=np.array(m.state.active),
        m_active=np.array(mg.active), m_H=np.array(mg.H), m_b=np.array(mg.b),
        m_q=np.array(mg.anchor_q), m_t=np.array(mg.anchor_t),
        m_c=np.array(mg.anchor_c))


def _sync(tm, jm):
    """Copy the JAX mapper's estimate (poses, codes, frame poses, marginal
    store, gauge anchor) into the port's, so that every event starts from
    one state and its comparison holds that event's arithmetic alone: left
    free, fp32 summation-order differences grow about fourfold per
    optimisation round (5e-5 m after the first eviction, 1.2e-3 m after the
    third)."""
    c = lambda dst, src: dst.copy_(torch.from_numpy(np.array(src)))
    c(tm.state.pose.q, jm.state.pose.q)
    c(tm.state.pose.t, jm.state.pose.t)
    c(tm.state.code, jm.state.code)
    c(tm.frames.pose.q, jm.frames.pose.q)
    c(tm.frames.pose.t, jm.frames.pose.t)
    for name in tm.marginals._fields:
        c(getattr(tm.marginals, name), getattr(jm.marginals, name))
    tm._anchor_pose = TSE3(torch.from_numpy(np.array(jm._anchor_pose.q)),
                           torch.from_numpy(np.array(jm._anchor_pose.t)))
    tm.update_map()


def _drive_pair(jm, tm, frames, rel):
    """Both mappers in lockstep through the same calls."""
    both = ((jm, JSE3), (tm, TSE3))
    pose = lambda SE, i: SE(np.array(rel[i].q, np.float32),
                            np.array(rel[i].t, np.float32))
    out = {id(m): dict(evicted=[], events=[]) for m, _ in both}

    def settle(m):
        while m.has_work():
            m.mapping_run()
        m.update_map()

    for m, SE in both:
        m.evict_callback = (lambda slot, kid, m=m:
                            out[id(m)]["evicted"].append((slot, kid)))
        s0, s1 = m.init_two_frames(frames[0], frames[2])
        m.update_map()
        m.enqueue_frame(frames[3], pose(SE, 3), s1)
        settle(m)
    for i in KF_FRAMES:
        _sync(tm, jm)
        for m, SE in both:
            # newest keyframe and its predecessor protected, as the facade
            # does
            m.protected_slots = set(m.kf_slots[-2:])
            p = pose(SE, i)
            m.enqueue_keyframe(frames[i], SE(p.q, p.t + np.array(
                [0.01, -0.005, 0.005], np.float32)))
            ev = _event(m)
            settle(m)
            ev["post"] = _snap(m)
            out[id(m)]["events"].append(ev)
    return dict(jax=out[id(jm)], torch=out[id(tm)])


def _runs():
    kw = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)[:KF_FRAMES[-1] + 1]
    frames = [np.array(f) for f in
              jsynth.render_sequence(scene, JCam.create(**kw), poses, H, W)]
    rel = [jse3.mul(jse3.inverse(poses[0]), p) for p in poses]
    ncfg = dict(code_size=CS, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    jdec = JDec(JNC(**ncfg), params=params)
    mk = lambda MC: MC(max_keyframes=K, max_frames=2, max_factors=16,
                       code_size=CS, height=H, width=W, pyramid_levels=2,
                       pho_iters=(4, 8), max_back_connections=2,
                       use_reprojection=False)
    return _drive_pair(
        JMapper(mk(JMC), JCam.create(**kw), decoder=jdec),
        TMapper(mk(TMC), TCam.create(**kw), decoder=_JaxOutputsDecoder(jdec),
                device="cpu"), frames, rel)


@pytest.fixture(scope="module")
def runs():
    return _runs()


N_EVENTS = len(KF_FRAMES)


def test_victims_identical_and_window_slides(runs):
    a, b = runs["torch"], runs["jax"]
    assert a["evicted"] == b["evicted"]
    assert [kid for _, kid in a["evicted"]] == [0, 1, 2]
    assert len(a["events"][-1]["slots"]) == K
    assert a["events"][-1]["n_archived"] == 3


@pytest.mark.parametrize("i", range(N_EVENTS))
def test_bookkeeping_after_event_matches_jax(runs, i):
    a, b = runs["torch"]["events"][i], runs["jax"]["events"][i]
    for k in ("slots", "ids", "pool", "links", "link_table", "n_archived",
              "arch_id"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["active"], b["active"])
    assert a["active"].sum() == len(a["slots"])
    # no live keyframe-to-keyframe factor references a free slot
    for s, d, isf, _ in a["pool"]:
        assert s in a["slots"] and (isf or d in a["slots"])


@pytest.mark.parametrize("i", range(N_EVENTS))
def test_archive_and_marginals_after_event_match_jax(runs, i):
    a, b = runs["torch"]["events"][i], runs["jax"]["events"][i]
    if b["arch_q"] is not None:
        np.testing.assert_allclose(a["arch_q"], b["arch_q"], atol=ARCHIVE_TOL)
        np.testing.assert_allclose(a["arch_t"], b["arch_t"], atol=ARCHIVE_TOL)
    np.testing.assert_array_equal(a["m_active"], b["m_active"])
    on = b["m_active"]
    assert on.any()                 # the one-way frame left a prior at least
    for k in ("m_q", "m_t", "m_c"):
        np.testing.assert_allclose(a[k][on], b[k][on], atol=ANCHOR_TOL)
    if b["n_archived"] == 0:
        assert np.abs(b["m_H"][on]).max() < 1.0    # round-off: see above
        return
    for k in ("m_H", "m_b"):
        scale = np.abs(b[k][on]).max()
        assert scale > 1.0
        np.testing.assert_allclose(a[k][on], b[k][on], atol=MARG_TOL * scale)


@pytest.mark.parametrize("i", range(N_EVENTS))
def test_window_after_next_optimisation_matches_jax(runs, i):
    a, b = runs["torch"]["events"][i], runs["jax"]["events"][i]
    live = a["slots"]
    for k in ("q", "t", "c"):
        np.testing.assert_allclose(a["post"][k][live], b["post"][k][live],
                                   atol=TOL)


def test_eviction_leaves_priors_on_the_neighbours(runs):
    """After the first eviction the victim's slot holds no prior and at
    least one surviving keyframe does."""
    ev = next(e for e in runs["torch"]["events"] if e["n_archived"] == 1)
    assert ev["m_active"][ev["slots"][:-1]].any()
    gone = [s for s in range(K) if s not in ev["slots"][:-1]]
    assert not ev["m_active"][gone].any()


# ----------------------------------------------------------------------------
# the arithmetic, on seeded inputs
# ----------------------------------------------------------------------------

def _jax_schur(H, g, B, N):
    """The elimination of the JAX ``_evict_body`` (mapper.py:957-979)."""
    H = 0.5 * (H + H.T)
    Hvv = H[:B, :B] + 1e-6 * jnp.eye(B)
    Hnv = H[B:, :B]
    sol = jnp.linalg.solve(Hvv, jnp.concatenate([Hnv.T, g[:B, None]], axis=1))
    Hnn = H[B:, B:] - Hnv @ sol[:, :-1]
    gn = g[B:] - Hnv @ sol[:, -1]
    Hb = jnp.einsum("ibjc,ij->ibc", Hnn.reshape(N, B, N, B), jnp.eye(N))
    Hb = 0.5 * (Hb + jnp.swapaxes(Hb, -1, -2))
    Hb = jnp.where(jnp.isfinite(Hb), Hb, 0.0)
    w, V = jnp.linalg.eigh(Hb)
    Hb = jnp.einsum("nbc,nc,ndc->nbd", V, jnp.clip(w, 0.0, None), V)
    return Hb, jnp.where(jnp.isfinite(gn), gn, 0.0).reshape(N, B)


@pytest.mark.parametrize("N", [1, 2, 3])
def test_schur_and_psd_arithmetic_matches_jax(N):
    """``schur_eliminate_block`` on a seeded well-posed system: 1e-5 of the
    largest |entry| (one fp32 solve and product in another order)."""
    B = 6 + CS
    D = (1 + N) * B
    rng = np.random.RandomState(N)
    J = rng.randn(4 * D, D).astype(np.float32)
    Hm = (J.T @ J).astype(np.float32)
    g = rng.randn(D).astype(np.float32)
    Hj, gj = _jax_schur(jnp.asarray(Hm), jnp.asarray(g), B, N)
    Ht, gt = tmapper.schur_eliminate_block(torch.from_numpy(Hm),
                                           torch.from_numpy(g), B, N)
    assert Ht.shape == (N, B, B) and gt.shape == (N, B)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj),
                               atol=1e-5 * np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj),
                               atol=1e-5 * np.abs(np.asarray(gj)).max())
    assert bool(tpsd.is_psd(Ht, tol=1e-3).all())


def test_schur_zeroes_non_finite_blocks():
    B, N = 6 + CS, 2
    D = (1 + N) * B
    Hm = torch.eye(D)
    Hm[B, B] = float("nan")
    Hb, gb = tmapper.schur_eliminate_block(Hm, torch.ones(D), B, N)
    assert torch.isfinite(Hb).all() and torch.isfinite(gb).all()


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_nearest_psd_and_is_psd_match_jax(eps):
    rng = np.random.RandomState(3)
    A = rng.randn(5, 8, 8).astype(np.float32)          # indefinite
    Pj = np.asarray(jpsd.nearest_psd(jnp.asarray(A), eps))
    Pt = tpsd.nearest_psd(torch.from_numpy(A), eps)
    np.testing.assert_allclose(Pt.numpy(), Pj, atol=1e-5)
    np.testing.assert_array_equal(
        tpsd.is_psd(torch.from_numpy(A)).numpy(),
        np.asarray(jpsd.is_psd(jnp.asarray(A))))
    np.testing.assert_array_equal(
        tpsd.is_psd(Pt, tol=1e-4).numpy(),
        np.asarray(jpsd.is_psd(jnp.asarray(Pj), tol=1e-4)))
    assert not tpsd.is_psd(torch.from_numpy(A)).any()
    assert tpsd.is_psd(Pt, tol=1e-4).all()


def _tiny_mapper():
    cam = TCam.create(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    cfg = TMC(max_keyframes=3, max_frames=1, max_factors=8, code_size=CS,
              height=H, width=W, pyramid_levels=2, pho_iters=(4, 8),
              use_reprojection=False)
    return TMapper(cfg, cam, decoder=None, device="cpu")


def test_select_victim_skips_protected_slots():
    m = _tiny_mapper()
    m.kf_slots = [2, 0, 1]
    assert m._select_victim() == 2
    m.protected_slots = {2}
    assert m._select_victim() == 0
    m.protected_slots = {2, 0}
    assert m._select_victim() == 1


def test_select_victim_raises_when_every_slot_is_protected():
    m = _tiny_mapper()
    m.kf_slots = [2, 0, 1]
    m.protected_slots = {0, 1, 2}
    with pytest.raises(RuntimeError, match="every slot is protected"):
        m._select_victim()


def test_reset_clears_eviction_state(runs):
    m = _tiny_mapper()
    m.archived.append({"id": 0})
    m.protected_slots = {1}
    m.links_host.append((0, (0, 1)))
    m.n_links, m._link_free = 3, [2]
    cb = lambda slot, kid: None
    m.evict_callback = cb
    m.reset()
    assert (m.archived, m.protected_slots, m.links_host) == ([], set(), [])
    assert (m.n_links, m._link_free) == (0, [])
    assert m.evict_callback is cb            # the observer outlives a reset
    assert not bool(m.state.link_active.any())
