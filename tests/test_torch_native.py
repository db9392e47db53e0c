"""The port's native runtime (deepfactors_tpu_torch/native.py and the
native scheduler backend) on the CPU. The port builds its own two
libraries from native/*.cpp with g++ (the scheduler alone, the loader with
libpng/libjpeg); the JAX package's prebuilt library is the reference where
it is built.

  - the native schedule (level, active, budget of every photometric slot
    after each bookkeeping) equals the port's Python scheduler's and the
    JAX package's native one, step for step; the convergence signal and
    fused_sig as in tests/test_native.py;
  - the mapper on the native backend equals the mapper on the Python one
    after the two-frame bootstrap (poses and codes within 1e-6) and
    recovers the true pose, as tests/test_native_mapper.py holds the JAX
    mapper; keyframe and frame works drain through it;
  - the loader's frames equal the Python decode (image_io) bit for bit on
    gray PNGs, and the JAX package's loader on the same files (resized
    too); load_depth_png equals the Python 16-bit decode times the scale;
  - a build that fails raises with the compiler's output.
"""
import os

import numpy as np
import pytest
import torch

from deepfactors_tpu_torch import native
from deepfactors_tpu_torch.io import image_io
from deepfactors_tpu_torch.mapping.scheduler import NativeBackend, \
    PyScheduler, make_scheduler

torch.set_num_threads(2)
ITERS = [(2, 3), (4, 8, 15), (1, 1, 1)]


class _Cfg:
    max_factors, max_rep_factors, max_geo_factors = 8, 4, 4
    max_keypoints, geo_npoints = 8, 4
    use_native_scheduler = False


def _trace(sched, iters, steps=50):
    """(level, active, budget) of the photo pool after each bookkeeping."""
    sched.add_photo(0, 1, False, list(iters))
    sched.add_photo(1, 0, False, list(iters), remove_after=True)
    out = []
    for _ in range(steps):
        if not sched.has_work():
            break
        sched.bookkeeping()
        b = sched.budget()
        p = sched.photo_pool
        out.append((tuple(p.level.tolist()), tuple(p.active.tolist()), b))
        sched.update(b, False)
    return out


def _jax_native_trace(iters, steps=50):
    from deepfactors_tpu import native as jn

    s = jn.NativeScheduler(8, 4, 4)
    s.add_work(jn.PHOTO, 0, 1, False, list(iters))
    s.add_work(jn.PHOTO, 1, 0, False, list(iters), remove_after=True)
    out = []
    for _ in range(steps):
        if not s.has_work():
            break
        s.bookkeeping()
        b = s.budget()
        _, _, level, _, act = s.pool(jn.PHOTO)
        out.append((tuple(level.tolist()), tuple(act.tolist()), b))
        s.update(b, False)
    return out


@pytest.mark.parametrize("iters", ITERS)
def test_native_schedule_matches_python_and_jax(iters):
    nat = _trace(NativeBackend(_Cfg()), iters)
    py = _trace(PyScheduler(_Cfg()), iters)
    assert len(nat) > 2 and nat == py
    from deepfactors_tpu import native as jn

    if jn.available():
        assert nat == _jax_native_trace(iters)


def test_convergence_signal_and_fused_sig():
    s = native.NativeScheduler(8, 4, 4)
    s.add_work(native.PHOTO, 0, 1, False, [5, 5])
    s.bookkeeping()
    n = 0
    while s.has_work() and n < 10:
        s.bookkeeping()
        s.update(1, True)
        n += 1
    assert not s.has_work() and n <= 4
    s = native.NativeScheduler(8, 4, 4)
    s.add_work(native.REP, 0, 1, False, [15])
    assert s.has_work() and s.fused_sig() is None
    s.add_work(native.PHOTO, 0, 1, False, [2, 3])
    assert s.fused_sig() is not None


def test_make_scheduler_selects_native():
    c = _Cfg()
    assert isinstance(make_scheduler(c), PyScheduler)
    c.use_native_scheduler = True
    assert isinstance(make_scheduler(c), NativeBackend)
    # the two libraries are the port's own
    for src in native.LIBS:
        native._load(src)
        assert native.lib_path(src).parent == native.build_dir()


def _mapper_scene():
    """Two views of a textured plane (tests/test_torch_mapper.py's kind)."""
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.geometry import warping as wp
    from deepfactors_tpu_torch.ops import image as ip

    H, W = 48, 64
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img0 = (0.5 + 0.25 * np.sin(xs / 4.0) * np.cos(ys / 3.0)
            + 0.1 * np.sin((xs + 2 * ys) / 7.0)).astype(np.float32)
    cam = PinholeCamera.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    d = torch.tensor([0.02, -0.01, 0.03, 0.008, -0.006, 0.01])
    pose1 = se3m.retract(se3m.identity(device="cpu"), d)
    pix = ds._pixel_grid(H, W, "cpu").reshape(-1, 2)
    # img1: img0 sampled through pose1^-1 at a depth of 2
    c = wp.find_correspondence(pix, torch.full((H * W,), 2.0), cam,
                               se3m.inverse(pose1), check_bounds=False)
    img1 = ip.bilinear_sample(torch.from_numpy(img0), c.pix1).reshape(H, W)
    return img0, img1.numpy(), cam, pose1


def _bootstrap(native_sched):
    from deepfactors_tpu_torch.mapping.mapper import Mapper, MapperConfig

    img0, img1, cam, pose1 = _mapper_scene()
    m = Mapper(MapperConfig(
        max_keyframes=4, max_frames=1, max_factors=8, code_size=4,
        height=48, width=64, pyramid_levels=2, pho_iters=(10, 15),
        connection_mode="LASTN", max_back_connections=2, use_schur=False,
        use_native_scheduler=native_sched), cam, decoder=None, device="cpu")
    assert isinstance(m.sched, NativeBackend) == native_sched
    m.init_two_frames(img0, img1)
    m.update_map()
    return m, img1, pose1


def test_native_mapper_matches_python():
    from deepfactors_tpu_torch.geometry import se3 as se3m

    a, img1, pose1 = _bootstrap(True)
    b, _, _ = _bootstrap(False)
    np.testing.assert_allclose(a.state.pose.t.numpy(), b.state.pose.t.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(a.state.code.numpy(), b.state.code.numpy(),
                               atol=1e-6)
    # img1 samples img0 through pose1^-1: keyframe 1's camera-to-world
    # pose is pose1^-1
    err = se3m.local(se3m.inverse(pose1),
                     se3m.index(a.state.pose, a.kf_slots[1]))
    assert float(torch.linalg.norm(err)) < 2e-2
    # a keyframe event and a one-way frame drain through the native backend
    a.enqueue_keyframe(img1, se3m.identity(device="cpu"))
    steps = 0
    while a.has_work() and steps < 80:
        a.mapping_step()
        steps += 1
    a.enqueue_frame(img1, se3m.identity(device="cpu"), kf_slot=a.kf_slots[-1])
    while a.has_work() and steps < 160:
        a.mapping_step()
        steps += 1
    assert steps < 160 and torch.isfinite(a.state.pose.t).all()
    assert a.dump_state()["works"] == []


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    ys, xs = np.mgrid[0:30, 0:40]
    for i in range(5):
        g = (127 + 100 * np.sin((xs + 3 * i) / 4.0) * np.cos(ys / 3.0)
             + rng.randint(-20, 20, (30, 40))).clip(0, 255).astype(np.uint8)
        image_io.imwrite(str(d / f"{i}.png"), g)
    image_io.imwrite(str(d / "depth.png"),
                     rng.randint(0, 60000, (30, 40)).astype(np.uint16))
    return d


def test_loader_matches_python_decode(frames_dir):
    files = sorted(str(p) for p in frames_dir.glob("[0-9].png"))
    loader = native.NativeLoader(files, timestamps=[0.5 * i for i in
                                                    range(len(files))],
                                 n_threads=3)
    assert loader.native_size == (40, 30)
    got = list(loader)
    assert [ts for ts, _ in got] == [0.5 * i for i in range(len(files))]
    for (_, img), f in zip(got, files):
        np.testing.assert_array_equal(
            img, image_io.imread(f, "gray").astype(np.float32) / 255.0)
    from deepfactors_tpu import native as jn

    if jn.available():
        for kw in ({}, {"out_w": 32, "out_h": 24}):
            a = list(native.NativeLoader(files, **kw))
            b = list(jn.NativeLoader(files, **kw))
            for (_, x), (_, y) in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_load_depth_png(frames_dir):
    p = str(frames_dir / "depth.png")
    d = native.load_depth_png(p, 1.0 / 5000.0)
    np.testing.assert_array_equal(
        d, image_io.imread(p, "any_depth").astype(np.float32)
        * np.float32(1.0 / 5000.0))
    with pytest.raises(IOError):
        native.load_depth_png(str(frames_dir / "missing.png"), 1.0)


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "scheduler.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(RuntimeError, match="native build of scheduler.cpp "
                                           "failed") as e:
        native.build("scheduler.cpp")
    assert "error" in str(e.value)
    assert not os.path.exists(tmp_path / "out" / "libscheduler.so")
