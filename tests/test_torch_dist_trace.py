"""The BA step's exchange in the port's tracer: over four gloo ranks at
48x64 every rank records ``ba.allreduce`` nested in ``ba.assemble`` once a
step and counts the bytes it all-reduces, 4 (D^2 + D + 2) a step at fp32;
with no group the step records neither and counts nothing."""
import json
import os
import subprocess
import sys

import torch

from deepfactors_tpu_torch.parallel import dist_ba
from deepfactors_tpu_torch.utils import timing

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, CS, H, W, STEPS = 4, 8, 48, 64, 2
D = K * (6 + CS)

_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from tests.test_torch_dist_trace import problem, traced_steps
torch.set_num_threads(1)
rendezvous, world, rank = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rendezvous,
                        world_size=world, rank=rank)
out = traced_steps(dist.group.WORLD, world, rank)
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


def problem(world=1, rank=0):
    """K keyframes of a smooth texture at 48x64 with small random code
    Jacobians, links to the next two keyframes; this rank's shard."""
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.parallel import large_map
    g = torch.Generator().manual_seed(3)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    images = torch.stack([0.5 + 0.25 * torch.sin((xs + 2 * k) / 5.0)
                          + 0.2 * torch.cos(ys / 4.0) for k in range(K)])
    grads = torch.stack([torch.gradient(images, dim=2)[0],
                         torch.gradient(images, dim=1)[0]], -1)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(K, 1)
    t = torch.zeros((K, 3))
    t[:, 0] = 0.02 * torch.arange(K)
    links = [(i, j) for i in range(K) for j in range(i + 1, min(K, i + 3))]
    return large_map.build_problem(
        images, torch.full((K, H, W), 0.5),
        0.01 * torch.randn((K, H, W, CS), generator=g),
        torch.zeros((K, H, W)), grads, SE3(q, t), torch.zeros((K, CS)),
        links, world, rank)


def traced_steps(group, world=1, rank=0) -> dict:
    """STEPS steps of ``make_ba_step`` with the tracer on: each span's name
    and its parent's name, and the bytes counted."""
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    pr = problem(world, rank)
    cam = PinholeCamera.create(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    step = dist_ba.make_ba_step(K, CS, cam, ds.SfmParams(
        huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0, valid_border=2),
        group=group)
    dist_ba.reset_allreduce_bytes()
    timing.reset_timing()
    timing.enable_timing(True)
    try:
        q, t, c = pr.pose_q, pr.pose_t, pr.codes
        for _ in range(STEPS):
            q, t, c, _ = step(q, t, c, pr.fd, pr.active)
        recs = timing.spans()
    finally:
        timing.enable_timing(False)
        timing.reset_timing()
    names = {r.id: r.name for r in recs}
    return {"spans": [[r.name, names.get(r.parent)] for r in recs],
            "bytes": dist_ba.allreduce_bytes(),
            "finite": bool(torch.isfinite(q).all()
                           and torch.isfinite(c).all())}


def test_four_gloo_ranks_trace_the_exchange(tmp_path):
    rendezvous = str(tmp_path / "rendezvous")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _SCRIPT, ROOT,
                               rendezvous, "4", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for o in outs:
        assert o["finite"]
        assert o["spans"].count(["ba.allreduce", "ba.assemble"]) == STEPS
        assert sum(s[0] == "ba.allreduce" for s in o["spans"]) == STEPS
        assert o["spans"].count(["ba.assemble", None]) == STEPS
        assert o["bytes"] == STEPS * 4 * (D * D + D + 2)


def test_no_group_no_exchange():
    o = traced_steps(None)
    assert o["finite"]
    names = [s[0] for s in o["spans"]]
    assert "ba.allreduce" not in names
    assert names.count("ba.assemble") == STEPS
    assert o["bytes"] == 0
    # the three phases, none nested
    assert all(s[1] is None for s in o["spans"])
