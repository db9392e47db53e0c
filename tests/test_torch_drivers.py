"""The port's dataset drivers (deepfactors_tpu_torch/io/drivers.py) against
the JAX package's (deepfactors_tpu/io/drivers.py) on directories this file
writes with cv2.imwrite: ScanNet, TUM (associate.txt and rgb.txt), ICL and
plain files, plus the synthetic driver, the URL errors, the sequence
collections and the TUM trajectory reader.

Tolerances: timestamps, intrinsics, images (gray float and BGR u8) and
depth identical (PNG is lossless and both decode to the same integers);
ground-truth poses within 1e-6 (the JAX package's pose arrays are float32,
its matrix-to-quaternion in jnp, the port's in torch); the synthetic
driver's frames within 1e-5 (the same texture and warp, rendered by XLA and
by PyTorch) and its poses within 1e-6. The port's ``files://`` decodes in
Python and equals cv2's gray decode (the JAX package's Python path); its
``files-native://`` runs the same C++ loader as the JAX package's
``files://`` (which takes the native path where its library is built) and
equals it; against the Python path it agrees bit for bit on gray images and
within 1.5 grey levels on colour ones (the loader keeps its float luma,
libpng truncates).
"""
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from deepfactors_tpu import native as jnative  # noqa: E402
from deepfactors_tpu.io import drivers as jdrv  # noqa: E402
from deepfactors_tpu_torch.io import drivers as drv  # noqa: E402

torch.set_num_threads(2)
H, W, N = 24, 32, 4


def _frames(seed=0):
    rng = np.random.RandomState(seed)
    return ([rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
             for _ in range(N)],
            [rng.randint(0, 20000, (H, W)).astype(np.uint16)
             for _ in range(N)])


def _pose_matrix(i):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec([0.1 * i, -0.05, 0.02 * i]).as_matrix()
    T[:3, 3] = [0.1 * i, -0.2, 0.3 + 0.01 * i]
    return T


def _same_frames(a, b, pose_tol=1e-6):
    fa, fb = list(a.frames()), list(b.frames())
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        assert x.timestamp == y.timestamp
        np.testing.assert_array_equal(x.img, np.asarray(y.img))
        assert x.img.dtype == np.float32
        for u, v in ((x.color, y.color), (x.gt_depth, y.gt_depth)):
            assert (u is None) == (v is None)
            if u is not None:
                np.testing.assert_array_equal(u, np.asarray(v))
        assert (x.gt_pose is None) == (y.gt_pose is None)
        if x.gt_pose is not None:
            assert x.gt_pose.q.device.type == "cpu"
            for u, v in zip(x.gt_pose, y.gt_pose):
                np.testing.assert_allclose(u.numpy(), np.asarray(v),
                                           atol=pose_tol)
    return fa


def test_scannet(tmp_path):
    colors, depths = _frames(0)
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(tmp_path / sub)
    K = np.array([[30.5, 0, 15.7, 0], [0, 29.5, 11.8, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    np.savetxt(tmp_path / "intrinsic" / "intrinsic_color.txt", K)
    for i in range(N):
        cv2.imwrite(str(tmp_path / "color" / f"{i}.png"), colors[i])
        cv2.imwrite(str(tmp_path / "depth" / f"{i}.png"), depths[i])
        np.savetxt(tmp_path / "pose" / f"{i}.txt", _pose_matrix(i))
    a = drv.get_interface_from_url(f"scannet://{tmp_path}")
    b = jdrv.get_interface_from_url(f"scannet://{tmp_path}")
    assert a.intrinsics() == b.intrinsics() == (30.5, 29.5, 15.7, 11.8, W, H)
    assert a.has_ground_truth and b.has_ground_truth
    fr = _same_frames(a, b)
    np.testing.assert_array_equal(fr[1].gt_depth,
                                  depths[1].astype(np.float32) * 0.001)


def _tum_dir(path, assoc: bool):
    colors, depths = _frames(1)
    os.makedirs(path / "rgb")
    os.makedirs(path / "depth")
    lines, gt = ["# rgb\n"], ["# timestamp tx ty tz qx qy qz qw\n"]
    for i in range(N):
        ts = f"{1305031102.175304 + 0.033 * i:.6f}"
        cv2.imwrite(str(path / "rgb" / f"{ts}.png"), colors[i])
        cv2.imwrite(str(path / "depth" / f"{ts}.png"), depths[i])
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n" if assoc
                     else f"{ts} rgb/{ts}.png\n")
    for i in range(2 * N):   # ground truth at twice the frame rate
        ts = 1305031102.175304 + 0.0165 * i + 0.002
        q = np.array([0.1 * i, -0.2, 0.3, 1.0])
        q /= np.linalg.norm(q)
        gt.append(f"{ts:.4f} {0.1 * i:.4f} 0.2 {-0.3 * i:.4f} "
                  f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    (path / ("associate.txt" if assoc else "rgb.txt")).write_text(
        "".join(lines))
    (path / "groundtruth.txt").write_text("".join(gt))
    return depths


@pytest.mark.parametrize("assoc", [True, False])
def test_tum_and_icl(tmp_path, assoc):
    depths = _tum_dir(tmp_path, assoc)
    for scheme in ("tum", "icl"):
        a = drv.get_interface_from_url(f"{scheme}://{tmp_path}")
        b = jdrv.get_interface_from_url(f"{scheme}://{tmp_path}")
        assert a.intrinsics() == b.intrinsics()
        assert a.has_ground_truth and b.has_ground_truth
        fr = _same_frames(a, b)
        if assoc:
            np.testing.assert_array_equal(
                fr[2].gt_depth, depths[2].astype(np.float32) * (1.0 / 5000.0))
        else:
            assert fr[0].gt_depth is None
    assert drv.get_interface_from_url(f"icl://{tmp_path}").intrinsics()[1] \
        == -480.0


def test_files(tmp_path):
    colors, _ = _frames(2)
    rng = np.random.RandomState(3)
    grays = [rng.randint(0, 256, (H, W)).astype(np.uint8) for _ in range(N)]
    for i in range(N):
        cv2.imwrite(str(tmp_path / f"c{i}.png"), colors[i])
        cv2.imwrite(str(tmp_path / f"g{i}.png"), grays[i])
    a = drv.get_interface_from_url(f"files://{tmp_path}")
    assert a.intrinsics() == (0.8 * W, 0.8 * W, W / 2, H / 2, W, H)
    assert not a.has_ground_truth
    fr = list(a.frames())
    assert [f.timestamp for f in fr] == [float(i) for i in range(2 * N)]
    for f, p in zip(fr, a.files):
        np.testing.assert_array_equal(
            f.img, cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
            / 255.0)
        np.testing.assert_array_equal(f.color, cv2.imread(p))
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    n = drv.get_interface_from_url(f"files-native://{tmp_path}")
    j = jdrv.get_interface_from_url(f"files://{tmp_path}")
    assert n.intrinsics() == j.intrinsics() == a.intrinsics()
    fn = _same_frames(n, j)
    # gray images: the native luma and the Python one agree bit for bit
    for x, y, p in zip(fn, fr, a.files):
        if os.path.basename(p).startswith("g"):
            np.testing.assert_array_equal(x.img, y.img)
        else:
            assert np.abs(x.img - y.img).max() <= 1.5 / 255


def test_synthetic_matches_jax():
    a = drv.get_interface_from_url("synthetic://64x48:6", device="cpu")
    b = jdrv.get_interface_from_url("synthetic://64x48:6")
    assert a.intrinsics() == b.intrinsics()
    fa, fb = list(a.frames()), list(b.frames())
    assert len(fa) == len(fb) == 6
    for x, y in zip(fa, fb):
        assert x.timestamp == y.timestamp and x.img.shape == (48, 64)
        assert np.abs(x.img - np.asarray(y.img)).max() <= 1e-5
        np.testing.assert_array_equal(x.gt_depth, y.gt_depth)
        for u, v in zip(x.gt_pose, y.gt_pose):
            assert u.device.type == "cpu"
            np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-6)
    # the default device is the card
    assert drv.SyntheticInterface("64x48:2").device.type == "cuda"


@pytest.mark.parametrize("url", ["no-scheme", "bogus://x"])
def test_url_errors(url):
    for mod in (drv, jdrv):
        with pytest.raises(ValueError):
            mod.get_interface_from_url(url)


def test_missing_data_raises(tmp_path):
    for url in (f"files://{tmp_path}", f"scannet://{tmp_path}"):
        with pytest.raises(IOError):
            drv.get_interface_from_url(url)


def test_sequence_collection(tmp_path):
    from deepfactors_tpu.io.sequences import SequenceCollection as J
    from deepfactors_tpu_torch.io.sequences import SequenceCollection as T

    f = tmp_path / "sequences.json"
    f.write_text(json.dumps({
        "scannet": {"base_dir": "/data/sn",
                    "sequences": {"scene0565_00": {"path": "s565",
                                                   "format": "scannet"},
                                  "scene0001_00": {"path": "s1"}}},
        "tum": {"sequences": {"fr1_desk": {"path": "/d/fr1"}}},
    }))
    t, j = T(str(f)), J(str(f))
    assert t.collections() == j.collections() == ["scannet", "tum"]
    assert t.sequences("scannet") == j.sequences("scannet")
    for name in ("scannet/scene0565_00", "scannet/scene0001_00",
                 "tum/fr1_desk"):
        assert t.resolve(name) == j.resolve(name)
    assert t.resolve("scannet/scene0565_00") == "scannet:///data/sn/s565"


def test_load_trajectory(tmp_path):
    from deepfactors_tpu.utils import tum_io as jtum
    from deepfactors_tpu_torch.utils import tum_io

    p = tmp_path / "traj.txt"
    p.write_text("# comment\n\n1.5 0.1 0.2 0.3 0.0 0.0 0.3826834 0.9238795\n"
                 "2.5 -1 0 2 0.1 0.2 0.3 0.9273618\n")
    a, b = tum_io.load_trajectory(str(p)), jtum.load_trajectory(str(p))
    assert [ts for ts, _ in a] == [ts for ts, _ in b] == [1.5, 2.5]
    for (_, x), (_, y) in zip(a, b):
        assert x.q.dtype == torch.float32 and x.q.device.type == "cpu"
        np.testing.assert_array_equal(x.q.numpy(), np.asarray(y.q))
        np.testing.assert_array_equal(x.t.numpy(), np.asarray(y.t))
    # a round trip through save_trajectory
    tum_io.save_trajectory(str(tmp_path / "back.txt"), a)
    again = tum_io.load_trajectory(str(tmp_path / "back.txt"))
    for (_, x), (_, y) in zip(a, again):
        np.testing.assert_allclose(x.t.numpy(), y.t.numpy(), atol=1e-6)
