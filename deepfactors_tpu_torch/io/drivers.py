"""Camera/dataset drivers with a URL-scheme factory.

PyTorch port of ``deepfactors_tpu/io/drivers.py`` (the reference's
sources/drivers/: interfaces registered under URL schemes,
camera_interface_factory.h:59-100): ``scannet://path``, ``tum://path``,
``icl://path``, ``files://dir`` and ``synthetic://WxH:n[:step]``, a
deterministic test sequence in place of the live OpenNI/FlyCapture slots.
Dataset readers expose ground-truth poses and depth where the dataset has
them (dataset_interface.h).

The readers are host-side: frames are numpy, read through the port's own
PNG codec (``io/image_io.py``; no OpenCV), and ground-truth poses are the
port's ``SE3`` of float32 CPU tensors. ``files://`` decodes in Python;
``files-native://`` decodes on the native loader's threads
(``native.NativeLoader``, libpng/libjpeg, built at first use; the build
raises where the headers are missing). The synthetic driver renders on its
``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..geometry import se3 as se3m
from ..geometry.se3 import SE3
from . import image_io


class FrameData(NamedTuple):
    timestamp: float
    img: np.ndarray                 # [H, W] float32 grayscale in [0, 1]
    color: Optional[np.ndarray]     # [H, W, 3] uint8 BGR or None
    gt_pose: Optional[SE3]          # camera-to-world if the dataset has it
    gt_depth: Optional[np.ndarray]  # [H, W] float32 meters or None


class CameraInterface:
    """Base interface (camera_interface.h equivalent)."""

    def intrinsics(self):
        """Returns (fx, fy, u0, v0, width, height)."""
        raise NotImplementedError

    def frames(self) -> Iterator[FrameData]:
        raise NotImplementedError

    @property
    def has_ground_truth(self) -> bool:
        return False


_REGISTRY = {}


def register_interface(scheme: str):
    """InterfaceRegistrar equivalent (camera_interface_factory.h:95-100)."""

    def deco(cls):
        _REGISTRY[scheme] = cls
        return cls

    return deco


def get_interface_from_url(url: str, device="cuda") -> CameraInterface:
    """CameraInterfaceFactory::GetInterfaceFromUrl. ``device`` is where a
    rendering driver (synthetic) renders; readers of files ignore it."""
    if "://" not in url:
        raise ValueError(f"Invalid camera url: {url} (expected scheme://path)")
    scheme, path = url.split("://", 1)
    if scheme not in _REGISTRY:
        raise ValueError(
            f"Unknown camera scheme '{scheme}'. "
            f"Supported: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[scheme](path, device=device)


def _imread_gray(path: str) -> np.ndarray:
    return image_io.imread(path, "gray").astype(np.float32) / 255.0


def _imread_color(path: str) -> np.ndarray:
    return image_io.imread(path, "color")


def _imread_depth(path: str, scale: float) -> np.ndarray:
    return image_io.imread(path, "any_depth").astype(np.float32) * scale


def _cpu_pose(q, t) -> SE3:
    return SE3(torch.as_tensor(np.asarray(q, np.float32)),
               torch.as_tensor(np.asarray(t, np.float32)))


@register_interface("scannet")
class ScanNetInterface(CameraInterface):
    """ScanNet export layout (scannet_interface.cpp:42-137): ``color/*.jpg``
    (or ``.png``), ``depth/*.png`` (mm), ``pose/*.txt`` (4x4
    cam-to-world), ``intrinsic/intrinsic_color.txt``."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.color_files = sorted(
            glob.glob(os.path.join(path, "color", "*.jpg"))
            + glob.glob(os.path.join(path, "color", "*.png")),
            key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
        )
        if not self.color_files:
            raise IOError(f"No ScanNet color frames under {path}")
        self._K = np.loadtxt(os.path.join(path, "intrinsic",
                                          "intrinsic_color.txt"))
        self._h, self._w = image_io.imread(self.color_files[0]).shape[:2]

    def intrinsics(self):
        K = self._K
        return (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                float(K[1, 2]), self._w, self._h)

    @property
    def has_ground_truth(self) -> bool:
        return os.path.isdir(os.path.join(self.path, "pose"))

    def frames(self):
        for cf in self.color_files:
            idx = os.path.splitext(os.path.basename(cf))[0]
            pose = None
            pose_file = os.path.join(self.path, "pose", f"{idx}.txt")
            if os.path.exists(pose_file):
                T = np.loadtxt(pose_file)
                if np.all(np.isfinite(T)):
                    pose = se3m.from_matrix(
                        torch.as_tensor(T, dtype=torch.float32))
            depth = None
            depth_file = os.path.join(self.path, "depth", f"{idx}.png")
            if os.path.exists(depth_file):
                depth = _imread_depth(depth_file, 0.001)  # mm -> m (:125)
            yield FrameData(float(idx), _imread_gray(cf), _imread_color(cf),
                            pose, depth)


@register_interface("tum")
class TumInterface(CameraInterface):
    """TUM RGB-D layout (tum_interface.cpp): associate.txt or rgb.txt +
    depth.txt + groundtruth.txt (``ts tx ty tz qx qy qz qw``)."""

    DEPTH_SCALE = 1.0 / 5000.0
    # freiburg1 default intrinsics
    DEFAULT_INTRINSICS = (517.3, 516.5, 318.6, 255.3, 640, 480)

    def __init__(self, path: str, device=None):
        self.path = path
        assoc = os.path.join(path, "associate.txt")
        self.pairs = []
        if os.path.exists(assoc):
            with open(assoc) as f:
                for line in f:
                    p = line.strip().split()
                    if len(p) >= 4 and not line.startswith("#"):
                        self.pairs.append((float(p[0]), p[1], p[3]))
        else:
            with open(os.path.join(path, "rgb.txt")) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    p = line.strip().split()
                    if len(p) >= 2:
                        self.pairs.append((float(p[0]), p[1], None))
        if not self.pairs:
            raise IOError(f"No TUM frames under {path}")
        self.gt = self._load_gt()

    def _load_gt(self):
        gt_file = os.path.join(self.path, "groundtruth.txt")
        if not os.path.exists(gt_file):
            return None
        data = []
        with open(gt_file) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = [float(x) for x in line.split()]
                if len(v) >= 8:
                    data.append(v[:8])
        return np.asarray(data) if data else None

    def intrinsics(self):
        return self.DEFAULT_INTRINSICS

    @property
    def has_ground_truth(self) -> bool:
        return self.gt is not None

    def _gt_pose_at(self, ts: float):
        """The ground-truth row nearest in time."""
        if self.gt is None:
            return None
        i = int(np.argmin(np.abs(self.gt[:, 0] - ts)))
        _, tx, ty, tz, qx, qy, qz, qw = self.gt[i]
        return _cpu_pose([qw, qx, qy, qz], [tx, ty, tz])

    def frames(self):
        for ts, rgb_rel, depth_rel in self.pairs:
            rgb = os.path.join(self.path, rgb_rel)
            depth = None
            if depth_rel:
                depth = _imread_depth(os.path.join(self.path, depth_rel),
                                      self.DEPTH_SCALE)
            yield FrameData(ts, _imread_gray(rgb), _imread_color(rgb),
                            self._gt_pose_at(ts), depth)


@register_interface("icl")
class IclNuimInterface(CameraInterface):
    """ICL-NUIM layout: TUM's association files with ICL intrinsics
    (icl_interface.cpp)."""

    DEFAULT_INTRINSICS = (481.2, -480.0, 319.5, 239.5, 640, 480)

    def __init__(self, path: str, device=None):
        self._tum = TumInterface(path)

    def intrinsics(self):
        return self.DEFAULT_INTRINSICS

    @property
    def has_ground_truth(self):
        return self._tum.has_ground_truth

    def frames(self):
        return self._tum.frames()


@register_interface("files")
class FileInterface(CameraInterface):
    """Plain image-directory driver (file_interface.cpp): sorted glob of
    images, timestamps 0, 1, ..., no ground truth; a pinhole guess for the
    intrinsics. Decodes in Python (``io/image_io.py``)."""

    native = False

    def __init__(self, path: str, device=None):
        exts = ("*.png", "*.jpg", "*.jpeg")
        self.files = sorted(
            f for e in exts for f in glob.glob(os.path.join(path, e)))
        if not self.files:
            raise IOError(f"No images under {path}")
        self._h, self._w = image_io.imread(self.files[0]).shape[:2]

    def intrinsics(self):
        # pinhole guess: 0.8*W focal, principal point at center
        return (0.8 * self._w, 0.8 * self._w, self._w / 2, self._h / 2,
                self._w, self._h)

    def frames(self):
        if self.native:
            from .. import native

            loader = native.NativeLoader(
                self.files, timestamps=[float(i) for i in range(len(self.files))],
                n_threads=3)
            for ts, img in loader:
                yield FrameData(ts, img, None, None, None)
            return
        for i, f in enumerate(self.files):
            yield FrameData(float(i), _imread_gray(f), _imread_color(f),
                            None, None)


@register_interface("files-native")
class NativeFileInterface(FileInterface):
    """``files://`` decoded by the native prefetch loader
    (native/dataset_loader.cpp, libpng/libjpeg; the JAX package's ``files``
    path where its library is built). Its luma for colour images is float
    (0.114 B + 0.587 G + 0.299 R), libpng's integer one in Python: the two
    agree bit for bit on gray images. No colour image is returned."""

    native = True


@register_interface("synthetic")
class SyntheticInterface(CameraInterface):
    """Deterministic synthetic sweep over a textured plane with exact
    ground-truth poses and depth, rendered on ``device``."""

    def __init__(self, spec: str, device="cuda"):
        # spec: "WxH:n_frames[:step]"
        parts = spec.split(":") if spec else []
        wh = parts[0] if parts and "x" in parts[0] else "256x192"
        self._w, self._h = (int(x) for x in wh.split("x"))
        self.n = int(parts[1]) if len(parts) > 1 else 30
        self.step = float(parts[2]) if len(parts) > 2 else 0.01
        self.device = torch.device(device)

    def intrinsics(self):
        return (0.9 * self._w, 0.9 * self._w, self._w / 2, self._h / 2,
                self._w, self._h)

    @property
    def has_ground_truth(self):
        return True

    def frames(self):
        from ..geometry import warping as wp
        from ..geometry.camera import PinholeCamera
        from ..ops import dense_sfm as ds
        from ..ops import image as ip

        H, W, dev = self._h, self._w, self.device
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        base = (0.5 + 0.22 * np.sin(xs / 9.0) + 0.18 * np.cos(ys / 7.0)
                + 0.08 * np.sin((2 * xs + ys) / 13.0)).astype(np.float32)
        # corner-rich blobs so feature detection/matching has texture
        rng = np.random.RandomState(12)
        for _ in range(max(8, H * W // 1500)):
            cy = rng.randint(8, H - 8)
            cx = rng.randint(8, W - 8)
            r = rng.randint(2, 5)
            base[cy - r:cy + r, cx - r:cx + r] = rng.uniform(0.05, 0.95)
        base = torch.as_tensor(np.clip(base, 0.0, 1.0), device=dev)
        fx, fy, u0, v0, _, _ = self.intrinsics()
        cam = PinholeCamera.create(fx=fx, fy=fy, u0=u0, v0=v0,
                                   width=W, height=H)
        pix = ds._pixel_grid(H, W, dev).reshape(-1, 2)
        dpt = torch.full((H * W,), 2.0, device=dev)
        for i in range(self.n):
            d = np.array([self.step * i, 0, 0.4 * self.step * i, 0,
                          0.1 * self.step * i, 0], np.float32)
            pose = se3m.retract(se3m.identity(device=dev),
                                torch.as_tensor(d, device=dev))
            corresp = wp.find_correspondence(pix, dpt, cam, pose,
                                             check_bounds=False)
            img = ip.bilinear_sample(base, corresp.pix1).reshape(H, W)
            yield FrameData(float(i), img.cpu().numpy(), None,
                            SE3(pose.q.cpu(), pose.t.cpu()),
                            np.full((H, W), 2.0, np.float32))
