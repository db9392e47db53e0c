"""Checkpoint and resume of the port (deepfactors_tpu_torch/utils/
checkpoint.py) against the JAX package's (deepfactors_tpu/utils/
checkpoint.py).

  - tests/test_training.py:50-80's round trip on the port: the restored
    system has the same keyframe, trajectory, poses and codes (1e-6) and
    goes on processing;
  - resume equals uninterrupted: a sequential run of the synthetic room
    orbit at 48x64 is checkpointed after a keyframe event, restored into a
    fresh system, and fed the rest of the frames; its trajectory, keyframe
    decisions and map must equal the uninterrupted run's. Both run on the
    CPU with the same operations in the same order, so the tolerance is
    1e-6 (in practice identical);
  - the arrays.npz of both packages for the same configuration hold the
    same keys with the same shapes.
"""
import os

import numpy as np
import pytest
import torch

from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.mapping.mapper import MapperConfig
from deepfactors_tpu_torch.system import DeepFactors, SystemConfig
from deepfactors_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)
H, W = 48, 64


def _img():
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return (0.5 + 0.3 * np.sin(xs / 5) * np.cos(ys / 4)).astype(np.float32)


def _cfg(mapper=None, **kw):
    m = dict(max_keyframes=4, max_frames=1, max_factors=8, code_size=4,
             height=H, width=W, pyramid_levels=2, pho_iters=(2, 3),
             use_schur=False)
    m.update(mapper or {})
    return SystemConfig(mapper=MapperConfig(**m), tracking_iterations=(4, 4),
                        loop_closure=False, **kw)


def _cam():
    return PinholeCamera.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2,
                                width=W, height=H)


def test_checkpoint_roundtrip(tmp_path):
    img = _img()
    df = DeepFactors(_cfg(), _cam(), decoder=None, device="cpu")
    df.bootstrap_two_frames(img, img)
    df.process_frame(2.0, img)
    ckpt.save_checkpoint(str(tmp_path / "ck"), df)
    assert sorted(os.listdir(tmp_path / "ck")) == ["arrays.npz",
                                                   "manifest.json",
                                                   "pools.pkl"]

    df2 = DeepFactors(_cfg(), _cam(), decoder=None, device="cpu")
    ckpt.load_checkpoint(str(tmp_path / "ck"), df2)
    assert df2.bootstrapped
    assert df2.curr_kf == df.curr_kf
    assert len(df2.trajectory) == len(df.trajectory)
    np.testing.assert_allclose(df2.mapper.state.pose.t.numpy(),
                               df.mapper.state.pose.t.numpy(), atol=1e-6)
    np.testing.assert_allclose(df2.mapper.state.code.numpy(),
                               df.mapper.state.code.numpy(), atol=1e-6)
    df2.process_frame(3.0, img)
    assert len(df2.trajectory) == len(df.trajectory) + 1


def _orbit(n):
    from deepfactors_tpu_torch.io import synth

    cam = PinholeCamera.create(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    poses = synth.orbit_trajectory(60, sweep=1.2 * np.pi)[:n]
    return cam, synth.render_sequence(synth.random_room(7, n_boxes=3), cam,
                                      poses, H, W, device="cpu")


def _run(cam, frames, start, stop, df=None):
    """Feed frames[start:stop] (bootstrap on 0 and 2 when df is None);
    returns the system and the keyframes built after each frame."""
    if df is None:
        df = DeepFactors(_cfg(dict(max_keyframes=8, max_frames=2,
                                   max_factors=32, max_back_connections=2),
                              tracking_dist_threshold=5.0,
                              frame_dist_threshold=0.12), cam, decoder=None,
                         device="cpu")
        df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    kfs = []
    for i in range(start, stop):
        df.process_frame(float(i), frames[i])
        kfs.append(df.mapper._next_kid)
    return df, kfs


def test_resume_equals_uninterrupted(tmp_path):
    cam, frames = _orbit(16)
    full, kfs = _run(cam, frames, 3, 16)
    # checkpoint after the first keyframe event past the bootstrap
    cut = 3 + next(i for i, k in enumerate(kfs) if k > 2) + 1
    assert cut < 14, kfs
    a, _ = _run(cam, frames, 3, cut)
    ckpt.save_checkpoint(str(tmp_path / "ck"), a)
    b = DeepFactors(a.cfg, cam, decoder=None, device="cpu")
    ckpt.load_checkpoint(str(tmp_path / "ck"), b)
    b, kfs_b = _run(cam, frames, cut, 16, df=b)
    assert kfs_b == kfs[cut - 3:]
    assert b.n_lost_frames == full.n_lost_frames == 0
    assert [ts for ts, _ in b.trajectory] == [ts for ts, _ in full.trajectory]
    for (_, p), (_, q) in zip(b.trajectory, full.trajectory):
        np.testing.assert_allclose(p.q, q.q, atol=1e-6)
        np.testing.assert_allclose(p.t, q.t, atol=1e-6)
    assert b.mapper.kf_slots == full.mapper.kf_slots
    for x, y in ((b.mapper.state.pose.t, full.mapper.state.pose.t),
                 (b.mapper.state.code, full.mapper.state.code),
                 (b.mapper.state.levels[0].dpt, full.mapper.state.levels[0].dpt)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


def test_arrays_match_jax_layout(tmp_path):
    from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
    from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
    from deepfactors_tpu.system import DeepFactors as JDF
    from deepfactors_tpu.system import SystemConfig as JSC
    from deepfactors_tpu.utils import checkpoint as jckpt

    img = _img()
    m = dict(max_keyframes=4, max_frames=1, max_factors=8, code_size=4,
             height=H, width=W, pyramid_levels=2, pho_iters=(2, 3),
             use_schur=False)
    j = JDF(JSC(mapper=JMC(**m), tracking_iterations=(4, 4),
                loop_closure=False),
            JCam.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2, width=W,
                        height=H), decoder=None)
    t = DeepFactors(_cfg(), _cam(), decoder=None, device="cpu")
    for df in (j, t):
        df.bootstrap_two_frames(img, img)
    jckpt.save_checkpoint(str(tmp_path / "j"), j)
    ckpt.save_checkpoint(str(tmp_path / "t"), t)
    a = np.load(tmp_path / "t" / "arrays.npz")
    b = np.load(tmp_path / "j" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
    # the JAX package's manifest keys are all there
    import json

    ma = json.load(open(tmp_path / "t" / "manifest.json"))
    mb = json.load(open(tmp_path / "j" / "manifest.json"))
    assert set(mb) <= set(ma)


def test_checkpoint_refuses_frames_in_flight(tmp_path):
    img = _img()
    df = DeepFactors(_cfg(pipeline_depth=1), _cam(), decoder=None,
                     device="cpu")
    df.bootstrap_two_frames(img, img)
    df.process_frame(2.0, img)
    with pytest.raises(RuntimeError, match="flush"):
        ckpt.save_checkpoint(str(tmp_path / "ck"), df)
    df.flush()
    ckpt.save_checkpoint(str(tmp_path / "ck"), df)
