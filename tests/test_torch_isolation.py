"""The port stands alone: no module of deepfactors_tpu_torch, and not
chip_smoke.py, imports jax, flax or deepfactors_tpu; and on CPU tensors
the kernel wrappers run their plain versions, so the launch counters stay
at 0."""
import os
import subprocess
import sys

import numpy as np
import torch

from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.ops import dense_sfm as tds
from deepfactors_tpu_torch.ops.kernels import dense_warp as tdw
from deepfactors_tpu_torch.ops.kernels import sfm_gram as tsg

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
class Blocker:
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "deepfactors_tpu")
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.BLOCKED:
            raise ImportError("blocked import: " + name)
        return None
for m in list(sys.modules):
    if m.split(".")[0] in Blocker.BLOCKED:
        del sys.modules[m]
sys.meta_path.insert(0, Blocker())
import deepfactors_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in Blocker.BLOCKED]
assert not bad, bad
print(" ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    seen = r.stdout.strip().splitlines()[-1].split()
    assert len(seen) >= 36                                # every module seen
    for mod in ("ops.kernels.dense_warp", "ops.kernels.sfm_error",
                "parallel.dist_ba", "parallel.large_map",
                "parallel.multi_seq", "parallel.dryrun",
                "loop.vocabulary", "loop.loop_detector",
                "features.sampler", "config"):
        assert "deepfactors_tpu_torch." + mod in seen, mod


def test_no_source_file_names_jax():
    """A static check beside the import probe: no import of jax, flax or
    deepfactors_tpu (with a dot or space after it) in the port's sources."""
    pkg = os.path.join(ROOT, "deepfactors_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1].split(".")[0]
                    assert mod not in ("jax", "jaxlib", "flax", "optax",
                                       "deepfactors_tpu"), (path, s)


def test_cpu_tensors_never_launch_a_kernel():
    tsg.reset_launch_counts()
    H, W = 24, 32
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(2, H, W).astype(np.float32))
    dpt = torch.full((2, H, W), 2.0)
    jac = torch.from_numpy((0.01 * rng.randn(2, 4, H, W)).astype(np.float32))
    cam = PinholeCamera.create(fx=30.0, fy=30.0, u0=W / 2, v0=H / 2, width=W,
                               height=H)
    pose = tse3.SE3(torch.tensor([[1.0, 0, 0, 0]] * 2), torch.zeros(2, 3))
    params = tsg.make_sfm_params(pose, cam, 1, 0.0, 0.3, 2.0)
    src = torch.tensor([0, 1], dtype=torch.int32)
    dst = torch.tensor([1, 0], dtype=torch.int32)
    G = tsg.se3_gram_batch(params, src, dst, img, dpt, img, grad_mode="interp")
    G2 = tsg.sfm_gram_batch(params, src, dst, img, dpt, jac, img,
                            grad_mode="interp")
    grad = torch.stack([img[1], img[1]], dim=-1)
    tds.se3_step(tse3.identity(device="cpu"), cam, img[0], img[1], dpt[0], grad, 0.3)
    tdw.reset_launch_counts()
    warped = tdw.dense_warp_batch(tdw.make_warp_params(pose, cam, 1, 0.0), dpt,
                                  img, img, img)
    planes = tdw.bilinear_warp_planes(img, warped[3][0], warped[4][0])
    assert G.shape == (2, 8, 8) and G2.shape == (2, 12, 12)
    assert len(warped) == 7 and planes.shape == (2, H, W)
    assert tsg.LAUNCHES == {"se3_gram_batch": 0, "sfm_gram_batch": 0}
    assert tdw.LAUNCHES == {"dense_warp_batch": 0, "bilinear_warp_planes": 0}
