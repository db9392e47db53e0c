"""Headless visualization and export.

PyTorch port of ``deepfactors_tpu/viz.py``: in place of the reference's
Pangolin GUI (sources/gui/: the surfel keyframe renderer drawkf.geom,
live/residual views, plots), a coloured point-cloud export (PLY) with the
stdev/validity/crop filtering of the geometry shader
(shaders/drawkf.geom:1-186), depth colormaps, image mosaics
(display_utils.h) and trajectory plots. The mosaics are written through the
port's PNG codec; the colormap is matplotlib's ``turbo`` table, carried
here with matplotlib's lookup, so that a host without matplotlib exports
the same images. Only ``plot_trajectory`` needs matplotlib.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .geometry import se3 as se3m
from .geometry.camera import PinholeCamera
from .geometry.se3 import SE3
from .io import image_io

# matplotlib's "turbo" ListedColormap (256 entries) as uint8 RGB, the value
# apply_colormap writes for each entry: (colour * 255) truncated
_TURBO_HEX = (
    "30123b31154232184a341b51351e5836215f37236538266c3929723a2c793b2f7f3c3285"
    "3c358b3d37913e3a963f3d9c4040a14043a64145ab4148b0424bb5434eba4350be4353c2"
    "4456c74458cb455bce455ed24560d64563d94666dd4668e0466be3466de64670e84673eb"
    "4675ed4678f0467af2467df4467ff64682f84584f94587fb4589fc448cfd438efd4291fe"
    "4193fe4096fe3f98fe3e9bfe3c9dfd3ba0fc39a2fc38a5fb36a8f934aaf833acf631aff5"
    "2fb1f32db4f12bb6ef2ab9ed28bbeb26bde925c0e623c2e421c4e120c6df1ec9dc1dcbda"
    "1ccdd71bcfd41ad1d219d3cf18d5cc18d7ca17d9c717dac417dcc217debf18e0bd18e1ba"
    "19e3b81ae4b61be5b41de7b11ee8af20e9ac22eba924eca627eda329eea02cef9d2ff09a"
    "32f19735f39438f4913bf48d3ff58a42f68746f7834af8804df97c51f97955fa7659fb72"
    "5dfb6f61fc6c65fc6869fd656dfd6271fd5f74fe5c78fe597cfe5680fe5384fe5087fe4d"
    "8bfe4b8efe4892fe4695fe4498fe429bfd409efd3ea1fc3da4fc3ba6fb3aa9fb39acfa37"
    "aef937b1f836b3f835b6f735b9f534bbf434bef334c0f233c3f133c5ef33c8ee33caed33"
    "cdeb34cfea34d1e834d4e735d6e535d8e335dae236dde036dfde36e1dc37e3da37e5d838"
    "e7d738e8d538ead339ecd139edcf39efcd39f0cb3af2c83af3c63af4c43af6c23af7c039"
    "f8be39f9bc39f9ba38fab737fbb537fbb336fcb035fcae34fdab33fda932fda631fda330"
    "fea12ffe9e2efe9b2dfe982cfd952bfd9229fd8f28fd8c27fc8926fc8624fb8323fb8022"
    "fa7d20fa7a1ff9771ef8741cf7711bf76e1af66b18f56817f46516f36315f26014f15d13"
    "ef5a11ee5810ed550fec520eea500de94d0de84b0ce6490be5460ae3440ae24209e04008"
    "de3e08dd3c07db3a07d93806d73606d63405d43205d23005d02f04ce2d04cb2b03c92903"
    "c72803c52602c32402c02302be2102bb1f01b91e01b61c01b41b01b11901ae1801ac1601"
    "a91501a61401a31201a011019d10019a0e01970d01940c01910b018e0a018b0901870801"
    "8407018106027d05027a0402"
)
_TURBO = np.frombuffer(bytes.fromhex(_TURBO_HEX), np.uint8).reshape(256, 3)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def keyframe_pointcloud(
    img: np.ndarray,      # [H, W] gray or [H, W, 3]
    dpt: np.ndarray,      # [H, W]
    pose_wk: SE3,
    cam: PinholeCamera,
    stdev: Optional[np.ndarray] = None,
    vld: Optional[np.ndarray] = None,
    stdev_thresh: float = 0.15,   # drawkf.geom stdev filter
    crop_pix: int = 2,            # border crop
    max_depth: float = 10.0,
):
    """World-space coloured points from one keyframe, filtered like the
    reference surfel shader. Returns (xyz [N, 3], rgb [N, 3] uint8)."""
    H, W = dpt.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    fx, fy = float(cam.fx), float(cam.fy)
    u0, v0 = float(cam.u0), float(cam.v0)
    z = dpt
    x = (xs - u0) / fx * z
    y = (ys - v0) / fy * z
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    keep = (z > 0) & (z < max_depth)
    keep &= (xs >= crop_pix) & (xs < W - crop_pix)
    keep &= (ys >= crop_pix) & (ys < H - crop_pix)
    if stdev is not None:
        keep &= np.exp(stdev) * np.sqrt(2.0) < stdev_thresh * z
    if vld is not None:
        keep &= vld > 0.5
    keep = keep.reshape(-1)

    q = torch.as_tensor(_np(pose_wk.q), dtype=torch.float32)
    R = se3m.quat_to_matrix(q).numpy()
    t = _np(pose_wk.t)
    xyz = pts[keep] @ R.T + t

    rgb = np.stack([img] * 3, axis=-1) if img.ndim == 2 else img
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    rgb = rgb.reshape(-1, 3)[keep]
    return xyz, rgb


def save_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """ASCII PLY point cloud."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(xyz)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{c[0]} {c[1]} {c[2]}\n")


def export_map_ply(path: str, mapper, cam: PinholeCamera, level: int = 0):
    """Export the whole keyframe map as one PLY (the GUI's map view).
    Returns the number of points."""
    st = mapper.state
    act = st.active.cpu().numpy()
    lvl, lvl_cam = st.levels[level], cam.level(level)
    all_xyz, all_rgb = [], []
    for s in mapper.kf_slots:
        if not act[s]:
            continue
        xyz, rgb = keyframe_pointcloud(
            _np(lvl.img[s]), _np(lvl.dpt[s]), se3m.index(st.pose, s),
            lvl_cam, stdev=_np(lvl.stdev[s]), vld=_np(lvl.vld[s]))
        all_xyz.append(xyz)
        all_rgb.append(rgb)
    if all_xyz:
        save_ply(path, np.concatenate(all_xyz), np.concatenate(all_rgb))
    return sum(len(x) for x in all_xyz)


def export_error_mosaics(path: str, mapper, cam, level: int = 0):
    """Per-factor photometric error images as one mosaic PNG (the debug
    error-image dumps of the reference, mapper.cpp:647-795): for every
    active keyframe-to-keyframe factor, |img0 - warp(img1)| masked by warp
    validity. Returns the factors' labels, or None without one."""
    from .geometry import warping as wp
    from .geometry.camera import camera_pyramid
    from .mapping import map_state as ms
    from .ops import dense_sfm as ds
    from .ops import image as ip

    state = ms.update_depth_all(mapper.state, mapper.cfg.avg_dpt)
    cams = camera_pyramid(cam, mapper.cfg.pyramid_levels)
    pool = mapper.sched.photo_pool
    lvl = state.levels[level]
    H, W = lvl.img.shape[1:]
    pix = ds._pixel_grid(H, W, lvl.img.device).reshape(-1, 2)

    tiles, labels = [], []
    for i in range(mapper.cfg.max_factors):
        if not pool.active[i] or pool.dst_is_frame[i]:
            continue
        s, d = int(pool.src[i]), int(pool.dst[i])
        pose_10 = se3m.mul(se3m.inverse(se3m.index(state.pose, d)),
                           se3m.index(state.pose, s))
        corr = wp.find_correspondence(pix, lvl.dpt[s].reshape(-1),
                                      cams[level], pose_10, border=1)
        samp = ip.bilinear_sample(lvl.img[d], corr.pix1).reshape(H, W)
        err = torch.abs(lvl.img[s] - samp) * corr.valid.reshape(H, W)
        tiles.append(err.cpu().numpy())
        labels.append(f"{s}->{d}")
    if not tiles:
        return None
    vmax = max(1e-6, max(float(t.max()) for t in tiles))
    colored = [apply_colormap(t, vmin=0.0, vmax=vmax) for t in tiles]
    cols = int(np.ceil(np.sqrt(len(colored))))
    rows = int(np.ceil(len(colored) / cols))
    mosaic = create_mosaic(colored, rows, cols)
    image_io.imwrite(path, mosaic[..., ::-1])  # RGB -> BGR
    return labels


def apply_colormap(img: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Turbo colormap -> [H, W, 3] uint8 RGB (display_utils
    apply_colormap equivalent); matplotlib's lookup: entry
    int(v * 256), 256 -> 255, NaN -> black."""
    vmin = np.nanmin(img) if vmin is None else vmin
    vmax = np.nanmax(img) if vmax is None else vmax
    norm = np.clip((img - vmin) / max(vmax - vmin, 1e-9), 0, 1)
    xa = np.array(norm, copy=True)
    if xa.dtype.kind != "f":
        xa = xa.astype(np.float64)
    xa *= 256
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0, xa), 0, 255).astype(int)
    out = _TURBO[idx]
    out[bad] = 0
    return out


def create_mosaic(images, rows: int, cols: int) -> np.ndarray:
    """Tile images into a grid (display_utils CreateMosaic equivalent)."""
    imgs = [np.asarray(im) for im in images]
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)

    def norm(im):
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        if im.dtype != np.uint8:
            im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        out = np.zeros((h, w, 3), np.uint8)
        out[: im.shape[0], : im.shape[1]] = im
        return out

    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(imgs[: rows * cols]):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = norm(im)
    return grid


def plot_trajectory(path: str, trajectory, gt=None):
    """Top-down (x, z) trajectory plot saved as PNG (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    P = np.stack([_np(p.t) for _, p in trajectory])
    ax.plot(P[:, 0], P[:, 2], "b-", label="estimate")
    if gt is not None:
        G = np.stack([_np(p.t) for _, p in gt])
        ax.plot(G[:, 0], G[:, 2], "g--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
