"""The geometric factors of deepfactors_tpu_torch.mapping.mapper against the
JAX Mapper: the geo pool through a sequence of events (keyframes, a geo
link, an eviction, stochastic resamples), a mapper pair with reprojection
and geometric factors on, the dense-solve fallback, the carry-across of
the geo pool and depth gradients, and the depth gradient's build.

Inputs: the textured plane of tests/test_torch_mapper_rep.py (48x64,
translated 3 px a frame) with the small random-init decoder (base_ch 8,
CS 4) carried across by ``params_from_jax``. The port's mapper takes its RANSAC hypotheses and its geometric
sample points from one replay of the JAX mapper's key chain
(``JaxKeyChain``: ``ransac_draw`` and ``geo_draw``), which the port calls
in JAX's order.

What must agree, with the tolerances:
  - the geo pool (src, dst, active, points of every slot) and the geo works
    after every event and after the mapping that follows it: identical
    (the points are the same draws, bit for bit);
  - the evictions: the same victims, and the same geo factors dropped with
    them;
  - keyframe poses and codes after each event's mapping: within 5e-4, the
    tolerance of tests/test_torch_mapper_rep.py (the decoders differ by
    bf16 rounding, ~1.5e-4 of depth);
  - ``dump_state``'s geo list: identical;
  - the solve: with geometric factors on, every GN iteration takes the
    dense Cholesky (``solve_damped``), never the Schur code solve, also
    where the configuration asks for Schur and D > 150."""
import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params
from test_torch_mapper_rep import JaxKeyChain, strip_pose, textured_strip

from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.mapping.mapper import Mapper as JMapper
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.models.decoder import Decoder as JDec
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping import mapper as tmapper
from deepfactors_tpu_torch.mapping.mapper import Mapper as TMapper
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.models.decoder import Decoder as TDec
from deepfactors_tpu_torch.models.decoder import NetworkConfig as TNC

torch.set_num_threads(2)
H, W, CS = 48, 64, 4
FX = 55.0
TOL = 5e-4
KF_FRAMES = (4, 6, 8, 10)
CAM = dict(fx=FX, fy=FX, u0=W / 2, v0=H / 2, width=W, height=H)


def config(MC, **kw):
    base = dict(max_keyframes=4, max_frames=2, max_factors=16, code_size=CS,
                height=H, width=W, pyramid_levels=2, pho_iters=(4, 8),
                max_back_connections=2, use_reprojection=True,
                max_keypoints=128, use_geometric=True, geo_npoints=32,
                geo_iters=5)
    base.update(kw)
    return MC(**base)


class Solves:
    """Counts the port mapper's dense and Schur solves."""

    def __init__(self, monkeypatch):
        self.dense = self.schur = 0
        sysm = tmapper.sysm
        dense, schur = sysm.solve_damped, sysm.solve_schur_codes

        def count_dense(*a):
            self.dense += 1
            return dense(*a)

        def count_schur(*a):
            self.schur += 1
            return schur(*a)

        monkeypatch.setattr(sysm, "solve_damped", count_dense)
        monkeypatch.setattr(sysm, "solve_schur_codes", count_schur)


def _geo_state(m):
    p = m.geo_pool
    live = np.nonzero(p.active)[0]
    return dict(works=sorted(w.name for w in m.work.work
                             if w.name.startswith("geo")),
                live=[(int(i), int(p.src[i]), int(p.dst[i])) for i in live],
                points=p.points[live].copy())


def _snap(m):
    p = m.keyframe_poses()
    return dict(q=np.array(p.q), t=np.array(p.t),
                c=np.array(m.keyframe_codes()), slots=list(m.kf_slots))


def _settle(m):
    while m.has_work():
        m.mapping_run()
    m.update_map()


def _pair(decoder, **kw):
    ncfg = dict(code_size=CS, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    if decoder:
        params = random_decoder_params(JNC(**ncfg), seed=0)
        jd = JDec(JNC(**ncfg), params=params)
        td = TDec(TNC(**ncfg), params=params, device="cpu")
    else:
        jd = td = None
    jm = JMapper(config(JMC, **kw), JCam.create(**CAM), decoder=jd)
    tm = TMapper(config(TMC, **kw), TCam.create(**CAM), decoder=td,
                 device="cpu")
    chain = JaxKeyChain()
    tm.ransac_draw = chain
    tm.geo_draw = chain.geo
    return jm, tm, chain


def _drive(m, SE, frames, evicted, link=False):
    """Bootstrap on frames 0 and 2, then a keyframe event per KF_FRAMES
    entry (the window of 4 evicts at the third and fourth), each followed
    by its mapping; with ``link`` a geometric link from the newest
    keyframe to the oldest after the second event."""
    out = {"events": []}
    m.evict_callback = lambda slot, kid: evicted.append((slot, kid))
    m.init_two_frames(frames[0], frames[2], pose1=strip_pose(SE, 2))
    m.update_map()
    out["init"] = _snap(m)
    for k, i in enumerate(KF_FRAMES):
        m.protected_slots = set(m.kf_slots[-2:])
        p = strip_pose(SE, i)
        before = _geo_state(m)["live"]
        m.enqueue_keyframe(frames[i], SE(p.q, p.t + np.array(
            [0.01, -0.005, 0.005], np.float32)))
        ev = {"queued": _geo_state(m), "evicted": list(evicted),
              "dropped": sorted(set(before) - set(_geo_state(m)["live"]))}
        if link and k == 1:
            m.enqueue_link(m.kf_slots[-1], m.kf_slots[0], photo=False,
                           geo=True)
        _settle(m)
        ev.update(geo=_geo_state(m), post=_snap(m))
        out["events"].append(ev)
    out["dump"] = m.dump_state()["geo_factors"]
    return out


@pytest.fixture(scope="module")
def runs():
    """The random decoder; reprojection and geometric factors on, with
    stochastic resampling and a geo link after the second event. A
    geometric work resamples at every bookkeeping after its first while it
    lives. A converged phase ends every work's level, so the threshold 0
    keeps each phase to its budget, and with 20 iterations the link's work
    outlives the photometric budgets around it."""
    jm, tm, chain = _pair(True, geo_stochastic=True, geo_iters=20,
                          relin_threshold=0.0)
    frames = textured_strip(KF_FRAMES[-1] + 1)
    with pytest.MonkeyPatch.context() as mp:
        solves = Solves(mp)
        out = dict(jax=_drive(jm, JSE3, frames, [], link=True),
                   torch=_drive(tm, TSE3, frames, [], link=True))
    out.update(solves=dict(dense=solves.dense, schur=solves.schur),
               geo_stats=dict(tm.geo_stats),
               rep_stats=dict(tm.rep_stats),
               calls=(chain.calls, chain.geo_calls), jax_mapper=jm)
    return out


@pytest.mark.parametrize("i", range(len(KF_FRAMES)))
def test_geo_pool_through_events_identical(runs, i):
    a, b = runs["torch"]["events"][i], runs["jax"]["events"][i]
    assert a["evicted"] == b["evicted"]
    assert a["dropped"] == b["dropped"]
    for stage in ("queued", "geo"):
        assert a[stage]["works"] == b[stage]["works"]
        assert a[stage]["live"] == b[stage]["live"]
        np.testing.assert_array_equal(a[stage]["points"], b[stage]["points"])
    assert a["geo"]["live"], "no geo factor live after the event"


def test_geo_pool_sequence_covers_links_evictions_resamples(runs):
    ev = runs["torch"]["events"]
    # two evictions, each dropping the geo factors of its victim
    assert len(ev[-1]["evicted"]) == 2
    for e in ev[2:]:
        victim = e["evicted"][-1][0]
        assert e["dropped"] and all(victim in (s, d)
                                    for _, s, d in e["dropped"])
    # the geo link of the second event: a factor from the newest keyframe
    # to the oldest
    assert any(src == 3 and dst == 0 for _, src, dst in ev[1]["geo"]["live"])
    # each event matched once; 2 samples at each of the four events and 1
    # at the link: the other draws are stochastic resamples
    assert runs["calls"][0] == len(KF_FRAMES)
    assert runs["calls"][1] > 9
    assert runs["torch"]["dump"] == runs["jax"]["dump"]
    assert len(runs["torch"]["dump"]) > 0


@pytest.mark.parametrize("stage", ["init"] + [f"event{i}" for i in
                                              range(len(KF_FRAMES))])
def test_geo_mapper_pair_poses_and_codes(runs, stage):
    if stage == "init":
        a, b = runs["torch"]["init"], runs["jax"]["init"]
    else:
        a = runs["torch"]["events"][int(stage[5:])]["post"]
        b = runs["jax"]["events"][int(stage[5:])]["post"]
    assert a["slots"] == b["slots"]
    for k in ("q", "t", "c"):
        np.testing.assert_allclose(a[k], b[k], atol=TOL)


def test_geo_mapper_pair_assembles_geo_and_solves_dense(runs):
    """Geo factors assembled in the GN iterations, beside rep factors, and
    every solve dense."""
    assert runs["geo_stats"]["iterations"] > 0
    assert runs["geo_stats"]["factor_terms"] > runs["geo_stats"]["iterations"]
    assert runs["rep_stats"]["iterations"] > 0
    assert runs["solves"]["dense"] > 0 and runs["solves"]["schur"] == 0


@pytest.mark.parametrize("use_geometric", [True, False])
def test_dense_fallback_with_schur_requested(monkeypatch, use_geometric):
    """D = 6*12 + 8*12 + 6*2 = 180 > 150 with use_schur=True: the Schur code
    solve without geometric factors, the dense Cholesky with them (a
    geometric factor couples two keyframes' codes)."""
    solves = Solves(monkeypatch)
    cfg = TMC(max_keyframes=12, max_frames=2, max_factors=8, code_size=8,
              height=H, width=W, pyramid_levels=2, pho_iters=(2, 2),
              use_schur=True, use_reprojection=False,
              use_geometric=use_geometric, geo_npoints=16, geo_iters=2)
    m = TMapper(cfg, TCam.create(**CAM), device="cpu")
    frames = textured_strip(3)
    m.init_two_frames(frames[0], frames[1], pose1=strip_pose(TSE3, 1))
    m.enqueue_keyframe(frames[2], strip_pose(TSE3, 2))
    _settle(m)
    assert solves.dense + solves.schur > 0
    if use_geometric:
        assert solves.schur == 0 and m.geo_pool.active.sum() == 2
    else:
        assert solves.dense == 0


def test_geo_state_carries_across_both_ways(runs):
    """``geo_state_to_numpy`` of the JAX mapper after the run, into a fresh
    port mapper with ``geo_state_from_numpy``, and back."""
    jm = runs["jax_mapper"]
    got = tmapper.geo_state_to_numpy(jm)
    assert got["geo_pool"].active.sum() > 0
    np.testing.assert_array_equal(got["dpt_grad"],
                                  np.asarray(jm.state.dpt_grad))
    tm = TMapper(config(TMC), TCam.create(**CAM), device="cpu")
    ver = tm.sched.repgeo_version
    tmapper.geo_state_from_numpy(tm, **got)
    assert tm.sched.repgeo_version > ver
    back = tmapper.geo_state_to_numpy(tm)
    for name in got["geo_pool"]._fields:
        np.testing.assert_array_equal(getattr(back["geo_pool"], name),
                                      getattr(got["geo_pool"], name))
    np.testing.assert_array_equal(back["dpt_grad"], got["dpt_grad"])


def test_dpt_grad_written_at_keyframe_build_only():
    """The map state's depth gradient of a keyframe is the Sobel gradient of
    its level-0 depth at the build, as the JAX map state writes it, and
    stays so when the code moves (as in JAX)."""
    from deepfactors_tpu_torch.ops import image as tip

    jm, tm, _ = _pair(True, use_reprojection=False)
    frames = textured_strip(3)
    for m, SE in ((jm, JSE3), (tm, TSE3)):
        for i in (0, 2):
            m.add_keyframe_to_map(frames[i], strip_pose(SE, i))
    dj = np.asarray(jm.state.levels[0].dpt[:2])
    dt = tm.state.levels[0].dpt[:2].clone()
    gt = tm.state.dpt_grad[:2].clone()
    for s in (0, 1):
        assert torch.equal(gt[s], tip.sobel_gradients(dt[s]))
    # the decoders differ by bf16 rounding: the Sobel filter (/8) has a gain
    # of 1, so the gradients differ by at most the depths' difference
    gap = float(np.abs(dt.numpy() - dj).max())
    assert 0 < gap < 1e-3
    np.testing.assert_allclose(gt.numpy(), np.asarray(jm.state.dpt_grad[:2]),
                               rtol=0, atol=gap + 1e-7)
    assert float(gt.abs().max()) > 10 * gap
    # the code moves and the depth with it; the gradient does not
    tm.state.code[1] += 0.2
    tm.update_map()
    assert not torch.equal(tm.state.levels[0].dpt[1], dt[1])
    assert torch.equal(tm.state.dpt_grad[:2], gt)
