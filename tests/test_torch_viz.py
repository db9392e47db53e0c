"""The port's headless visualisation (deepfactors_tpu_torch/viz.py)
against the JAX package's (deepfactors_tpu/viz.py) on the same numpy
inputs from a seed.

Exact: apply_colormap (the port carries matplotlib's turbo table and its
lookup), create_mosaic, save_ply's text. keyframe_pointcloud: the same
points kept and colours, coordinates within 1e-5 (the rotation matrix from
the quaternion in torch against jnp). export_map_ply and
export_error_mosaics on the port's map (a two-keyframe bootstrap at 48x64,
CPU) against the same functions computed here from the map's tensors.
"""
import numpy as np
import pytest
import torch

from deepfactors_tpu import viz as jviz
from deepfactors_tpu_torch import viz
from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.geometry.se3 import SE3

torch.set_num_threads(2)


@pytest.mark.parametrize("vrange", [(None, None), (0.0, 0.8), (0.2, 0.21)])
def test_apply_colormap_matches_jax(vrange):
    rng = np.random.RandomState(0)
    img = rng.rand(40, 50).astype(np.float32)
    img[3, 4] = np.nan
    a, b = viz.apply_colormap(img, *vrange), jviz.apply_colormap(img, *vrange)
    assert a.dtype == np.uint8 and a.shape == (40, 50, 3)
    np.testing.assert_array_equal(a, b)


def test_mosaic_and_ply_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    imgs = [rng.rand(6, 7).astype(np.float32),
            rng.randint(0, 256, (5, 7, 3)).astype(np.uint8),
            rng.rand(6, 4, 3).astype(np.float32)]
    np.testing.assert_array_equal(viz.create_mosaic(imgs, 2, 2),
                                  jviz.create_mosaic(imgs, 2, 2))
    xyz = rng.randn(9, 3).astype(np.float32)
    rgb = rng.randint(0, 256, (9, 3)).astype(np.uint8)
    viz.save_ply(str(tmp_path / "a.ply"), xyz, rgb)
    jviz.save_ply(str(tmp_path / "b.ply"), xyz, rgb)
    assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()


def test_keyframe_pointcloud_matches_jax():
    import jax.numpy as jnp

    from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
    from deepfactors_tpu.geometry.se3 import SE3 as JSE3

    rng = np.random.RandomState(2)
    H, W = 20, 24
    img = rng.rand(H, W).astype(np.float32)
    dpt = (0.5 + 3 * rng.rand(H, W)).astype(np.float32)
    stdev = rng.randn(H, W).astype(np.float32) - 2
    vld = rng.rand(H, W).astype(np.float32)
    q = np.array([0.9, 0.1, -0.3, 0.2], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([0.3, -0.1, 1.2], np.float32)
    cam = dict(fx=20.0, fy=21.0, u0=11.5, v0=9.5, width=W, height=H)
    a = viz.keyframe_pointcloud(img, dpt, SE3(torch.from_numpy(q),
                                              torch.from_numpy(t)),
                                PinholeCamera.create(**cam), stdev, vld)
    b = jviz.keyframe_pointcloud(img, dpt, JSE3(jnp.asarray(q),
                                                jnp.asarray(t)),
                                 JCam.create(**cam), stdev, vld)
    assert len(a[0]) == len(b[0]) > 0
    np.testing.assert_allclose(a[0], np.asarray(b[0]), atol=1e-5)
    np.testing.assert_array_equal(a[1], b[1])


def test_exports_on_a_map(tmp_path):
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.io import image_io
    from deepfactors_tpu_torch.mapping.mapper import MapperConfig
    from deepfactors_tpu_torch.system import DeepFactors, SystemConfig

    H, W = 48, 64
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img0 = (0.5 + 0.3 * np.sin(xs / 5) * np.cos(ys / 4)).astype(np.float32)
    img1 = np.roll(img0, 2, axis=1)
    cam = PinholeCamera.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    df = DeepFactors(SystemConfig(
        mapper=MapperConfig(max_keyframes=4, max_frames=1, max_factors=8,
                            code_size=4, height=H, width=W,
                            pyramid_levels=2, pho_iters=(2, 3),
                            use_schur=False),
        tracking_iterations=(4, 4), loop_closure=False), cam, decoder=None,
        device="cpu")
    df.bootstrap_two_frames(img0, img1)
    m = df.mapper
    n = viz.export_map_ply(str(tmp_path / "map.ply"), m, cam)
    st = m.state
    want = sum(len(viz.keyframe_pointcloud(
        st.levels[0].img[s].numpy(), st.levels[0].dpt[s].numpy(),
        se3m.index(st.pose, s), cam, st.levels[0].stdev[s].numpy(),
        st.levels[0].vld[s].numpy())[0]) for s in m.kf_slots)
    assert n == want
    labels = viz.export_error_mosaics(str(tmp_path / "err.png"), m, cam)
    pool = m.sched.photo_pool
    live = [f"{int(pool.src[i])}->{int(pool.dst[i])}"
            for i in range(len(pool.active))
            if pool.active[i] and not pool.dst_is_frame[i]]
    assert labels == live and len(labels) == 2
    mosaic = image_io.imread(str(tmp_path / "err.png"), "color")
    # two tiles side by side, each a colormapped error image
    assert mosaic.shape == (H, 2 * W, 3)
    assert mosaic[:, :W].any() and mosaic[:, W:].any()
