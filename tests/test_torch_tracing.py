"""The port's tracer (``deepfactors_tpu_torch/utils/timing.py``) on the CPU.

Off, a span records nothing and never enters ``record_function``; under a
``torch.profiler`` session spans record with their parents, their host
intervals within 1 ms of the profiler's own ``record_function`` events
(loose on purpose: the suite runs under several workers, so this checks
the clock, not its precision); stacks are per thread; the pipelined frame
path gives a retired frame's spans that frame's number; the cap counts
drops; ``timing_summary()``'s self times add up; and the BA step and the
training step open their three spans in order and give, traced, the same
outputs bit for bit as untraced."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepfactors_tpu_torch import demo
from deepfactors_tpu_torch.geometry import se3 as se3m
from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.io import synth
from deepfactors_tpu_torch.mapping.mapper import MapperConfig
from deepfactors_tpu_torch.models import decoder as tdm
from deepfactors_tpu_torch.models import train_decoder as ttd
from deepfactors_tpu_torch.ops import dense_sfm as ds
from deepfactors_tpu_torch.ops import image as ip
from deepfactors_tpu_torch.parallel import dist_ba, large_map
from deepfactors_tpu_torch.system import DeepFactors, SystemConfig
from deepfactors_tpu_torch.utils import timing

torch.set_num_threads(2)
CLOCK_NS = 1_000_000


@pytest.fixture(autouse=True)
def fresh():
    timing.enable_timing(False)
    timing.reset_timing()
    yield
    timing.enable_timing(False)
    timing.reset_timing()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_path_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with tracing off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = timing.span("a"), timing.span("b", frame=3)
    assert a is b                      # one shared null context
    with a:
        with b:
            timing.tag(3, "track")
    assert timing.spans() == [] and timing.timing_summary() == {}


def test_spans_record_under_the_profiler_with_their_parents():
    with _cpu_profile():
        with timing.span("root", frame=7):
            with timing.span("child"):
                with timing.span("leaf"):
                    pass
            timing.tag(7, "keyframe")
        with timing.span("other"):
            pass
    got = {s.name: s for s in timing.spans()}
    assert [s.name for s in timing.spans()] == ["leaf", "child", "root",
                                                "other"]
    assert got["root"].parent == 0 and got["other"].parent == 0
    assert got["child"].parent == got["root"].id
    assert got["leaf"].parent == got["child"].id
    assert got["leaf"].trace == got["child"].trace == got["root"].trace == 7
    assert got["other"].trace is None
    assert got["root"].kind == "keyframe" and got["child"].kind is None
    for s in got.values():
        assert s.host_start_ns <= s.host_end_ns
        assert s.dev_start_ns is None       # no card: no device interval
    with timing.span("after"):          # the session ended: off again
        pass
    assert len(timing.spans()) == 4


def test_host_intervals_match_the_profilers_events():
    with _cpu_profile() as prof:
        for i in range(5):
            with timing.span(f"s{i}"):
                time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in timing.spans():
        e = events[s.name]
        assert abs(e.start_ns() - s.host_start_ns) < CLOCK_NS
        assert abs(e.start_ns() + e.duration_ns() - s.host_end_ns) < CLOCK_NS


def test_stacks_are_per_thread():
    timing.enable_timing(True)
    barrier = threading.Barrier(2)

    def work(tag):
        with timing.span(f"outer{tag}", frame=tag):
            barrier.wait(timeout=10)
            with timing.span(f"inner{tag}"):
                barrier.wait(timeout=10)
    threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in timing.spans()}
    for k in (1, 2):
        assert got[f"inner{k}"].parent == got[f"outer{k}"].id
        assert got[f"inner{k}"].trace == k
        assert got[f"inner{k}"].thread == got[f"outer{k}"].thread
    assert got["outer1"].thread != got["outer2"].thread


def test_the_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(timing, "CAP", 3)
    timing.enable_timing(True)
    for i in range(5):
        with timing.span(f"s{i}"):
            pass
    assert [s.name for s in timing.spans()] == ["s0", "s1", "s2"]
    assert timing.dropped() == 2
    timing.reset_timing()
    assert timing.spans() == [] and timing.dropped() == 0


def test_summary_self_times_add_up():
    timing.enable_timing(True)
    for _ in range(3):
        with timing.span("a"):
            time.sleep(0.001)
            with timing.span("b"):
                time.sleep(0.001)
                with timing.span("c"):
                    time.sleep(0.001)
            with timing.span("c"):
                pass
    recs = timing.spans()
    summ = timing.timing_summary()
    assert {k: v["count"] for k, v in summ.items()} == {"a": 3, "b": 3,
                                                       "c": 6}
    roots = sum(r.host_end_ns - r.host_start_ns for r in recs
                if not r.parent) / 1e6
    assert sum(v["host_self_ms"] for v in summ.values()) == \
        pytest.approx(roots, rel=1e-9)
    assert summ["a"]["host_self_ms"] < summ["a"]["host_ms"]
    assert summ["c"]["host_self_ms"] == pytest.approx(summ["c"]["host_ms"])


# --- the frame path, pipelined --------------------------------------------

H, W = 48, 64


def _facade(depth):
    cam = PinholeCamera.create(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    scene = synth.random_room(11, n_boxes=2, freq_scale=0.3)
    poses = synth.orbit_trajectory(16, radius=0.5, sweep=0.48 * np.pi)
    frames, depths = synth.render_sequence(scene, cam, poses, H, W,
                                           with_depth=True, device="cpu")
    oracle = synth.OracleDecoder(frames, depths, levels=2, code_size=4)
    cfg = SystemConfig(
        mapper=MapperConfig(
            max_keyframes=4, max_frames=1, max_factors=16, code_size=4,
            height=H, width=W, pyramid_levels=2, pho_iters=(4, 6),
            connection_mode="LASTN", max_back_connections=2,
            use_schur=False),
        dist_threshold=0.6, frame_dist_threshold=0.5, pipeline_depth=depth)
    df = DeepFactors(cfg, cam, decoder=oracle, device="cpu")
    return df, frames


def test_pipelined_frames_keep_their_numbers():
    df, frames = _facade(depth=1)
    timing.enable_timing(True)
    df.bootstrap_two_frames(frames[0], frames[1])
    for i in range(2, len(frames)):
        df.process_frame(float(i), frames[i])
    df.flush()
    recs = timing.spans()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.name == "frame"]
    assert [r.trace for r in roots] == list(range(1, len(frames) - 1))
    assert all(r.parent == 0 for r in roots)
    retires = [r for r in recs if r.name == "frame.retire"]
    assert sorted(r.trace for r in retires) == [r.trace for r in roots]
    for r in retires:
        up = by_id.get(r.parent)
        if up is None:                  # retired by flush: a root itself
            assert r.parent == 0 and r.trace == roots[-1].trace
        else:                           # retired by the next frame's call
            assert up.name == "frame" and up.trace == r.trace + 1
        assert r.kind in ("track", "keyframe", "frame", "loop", "lost")
    # every span under a retire carries the retired frame's number
    for r in recs:
        up = by_id.get(r.parent)
        if up is not None and up.name == "frame.retire":
            assert r.trace == up.trace, r
    kinds = {r.kind for r in retires}
    assert "keyframe" in kinds and "track" in kinds, kinds
    assert any(r.name == "kf.build" for r in recs)
    assert any(r.name == "bootstrap" and r.parent == 0 for r in recs)
    assert df.n_frames == len(frames) - 2


def test_demo_prints_the_summary_once(tmp_path):
    cfg = tdm.NetworkConfig(code_size=8, pyramid_levels=2, input_width=64,
                            input_height=48)
    tdm.save_params(str(tmp_path / "net.pkl"), tdm.params_to_jax(
        tdm.Decoder(cfg, device="cpu", seed=3).module.state_dict()))
    (tmp_path / "net.json").write_text(
        '{"code_size": 8, "pyramid_levels": 2, "input_width": 64, '
        '"input_height": 48, "avg_dpt": 2.0}')
    lines = []
    demo.run(["--device", "cpu", "--source", "synthetic://64x48:5",
              "--log_dir", str(tmp_path / "run"),
              "--network_path", str(tmp_path / "net.json"),
              "--network_weights", str(tmp_path / "net.pkl"),
              "--pyramid_levels=2", "--code_size=8", "--pho_iters=4,8",
              "--tracking_iterations=5,5", "--use_reprojection=false",
              "--loop_closure=false", "--enable_timing=true"],
             log=lines.append)
    timed = [ln for ln in lines if ln.startswith("[timing] ")]
    names = [ln.split(":")[0][len("[timing] "):] for ln in timed]
    assert len(names) == len(set(names))            # each name once
    assert {"bootstrap", "frame", "frame.step", "kf.build"} <= set(names)
    # the summary comes last, after the run's own lines
    assert lines[-len(timed):] == timed
    assert not timing._enabled


# --- the BA step and the training step --------------------------------------

BK, BCS, BH, BW = 3, 4, 24, 32


def _ba_problem():
    ys, xs = torch.meshgrid(torch.arange(BH, dtype=torch.float32),
                            torch.arange(BW, dtype=torch.float32),
                            indexing="ij")
    images = torch.stack([0.5 + 0.25 * torch.sin((xs + 0.7 * k) / 5.0)
                          + 0.2 * torch.cos(ys / 4.0) for k in range(BK)])
    grads = torch.stack([ip.sobel_gradients(im) for im in images])
    g = torch.Generator().manual_seed(0)
    jac = 0.01 * torch.randn((BK, BH, BW, BCS), generator=g)
    d = torch.zeros((BK, 6))
    d[:, 0] = 0.02 * torch.arange(BK)
    d[1:, 4] = 0.003
    poses = se3m.retract(se3m.identity((BK,), device="cpu"), d)
    problem = large_map.build_problem(
        images, torch.full((BK, BH, BW), 0.5), jac, torch.zeros(BK, BH, BW),
        grads, poses, torch.zeros(BK, BCS), [(0, 1), (1, 2), (0, 2)])
    cam = PinholeCamera.create(fx=30.0, fy=30.0, u0=BW / 2, v0=BH / 2,
                               width=BW, height=BH)
    step = dist_ba.make_ba_step(BK, BCS, cam, ds.SfmParams(
        huber_delta=0.3, valid_border=1), pose_prior=0.05)
    return problem, step


def _ba_run(problem, step, iters=2):
    q, t, c = problem.pose_q, problem.pose_t, problem.codes
    out = []
    for _ in range(iters):
        q, t, c, stats = step(q, t, c, problem.fd, problem.active)
        out += [q, t, c, stats]
    return out


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_ba_step_spans_in_order_and_outputs_unchanged():
    problem, step = _ba_problem()
    off = _ba_run(problem, step)
    assert timing.spans() == []
    with _cpu_profile():
        on = _ba_run(problem, step)
    _bitwise(off, on)
    names = [s.name for s in sorted(timing.spans(),
                                    key=lambda s: s.host_start_ns)]
    assert names == ["ba.linearise", "ba.assemble", "ba.solve"] * 2
    assert all(s.parent == 0 for s in timing.spans())
    assert bool(torch.isfinite(on[-1]).all())


def _train_setup():
    CS, L, TH, TW = 4, 2, 16, 24
    model = ttd.VAEModel(CS, L, base_ch=4, input_hw=(TH, TW))
    tdm.init_flax_defaults(model, torch.Generator().manual_seed(0))
    opt = ttd.OptaxAdam(model.parameters(), 3e-4, clip_norm=1.0,
                        weight_decay=1e-4)
    g = torch.Generator().manual_seed(1)
    imgs = torch.rand((2, TH, TW), generator=g)
    gts = 0.3 + 0.4 * torch.rand((2, TH, TW), generator=g)
    eps = torch.randn((2, CS), generator=g)
    return model, opt, imgs, gts, eps


def _train_run():
    model, opt, imgs, gts, eps = _train_setup()
    step = ttd.make_train_step(model, opt)
    out = []
    for _ in range(2):
        loss, aux = step(imgs, gts, eps=eps)
        out += [loss] + [aux[k] for k in sorted(aux)]
    return out + [p.detach() for p in model.parameters()]


def test_train_step_spans_in_order_and_outputs_unchanged():
    off = _train_run()
    with _cpu_profile():
        on = _train_run()
    _bitwise(off, on)
    names = [s.name for s in sorted(timing.spans(),
                                    key=lambda s: s.host_start_ns)]
    assert names == ["train.forward", "train.backward",
                     "train.optimiser"] * 2
