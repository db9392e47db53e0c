"""Cells of the benchmark cut to a size the CPU tests hold: 48x64 images, a
decoder of base width 8 and code size 8 (weights from the seed), 6
keyframes of 3 iterations, training batches of 4 from 2 rooms x 8 views.
The limits are the cell's own."""
from __future__ import annotations

import time

import torch

from portbench import harness

SMALL = dict(input_height=48, input_width=64, fx=55.0, fy=55.0, u0=32.0,
             v0=24.0, base_ch=8, code_size=8)


def cell(name: str, root=harness.ROOT) -> harness.Cell:
    c = harness.find_cell(harness.load_manifest(root), name, root)
    cfg = dict(c.config, **SMALL)
    if "K" in c.traffic:            # a large map
        cfg.update(weights=None, iters=3, back=2)
        tr = dict(c.traffic, K=6, starts=4, check_solves=2, trace_units=2)
    else:
        cfg.update(rooms=2, poses_per_room=8, log_every=2)
        tr = dict(c.traffic, batch=4, warm_steps=1, trace_units=3)
    return c._replace(config=cfg, traffic=tr)


def run(name: str, seed: int = 5, trace: bool = False, fault=None,
        root=harness.ROOT, device="cpu", seconds: float = 0.5) -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(cell(name, root), seed, seconds, trace,
                            torch.device(device), time.perf_counter(),
                            fault=fault, log=lambda *a: None, root=root)


def tiny_problem(K: int = 5, seed: int = 4):
    """A small large map for both sides: K views of the orbit at 48x64,
    decoded by a decoder of base width 8 with weights from the seed, links
    to the last two keyframes, starts off the truth. (port problem,
    reference inputs, camera, port camera, sfm, priors)."""
    import numpy as np

    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.parallel import large_map
    from portbench import synth
    from portbench.reference import largemap as rlm
    from portbench.reference import net

    torch.set_num_threads(2)
    cfg = dict(harness.load_json(harness.ROOT / "portbench" / "configs"
                                 / "largemap.json"), **SMALL)
    dev = torch.device("cpu")
    H, W = cfg["input_height"], cfg["input_width"]
    cam = synth.Camera(cfg["fx"], cfg["fy"], cfg["u0"], cfg["v0"], float(W),
                       float(H))
    q, t = synth.orbit_trajectory(300, sweep=3.2 * np.pi)
    q, t = q[::2][:K], t[::2][:K]
    scene = synth.random_room(seed)
    images = synth.render_aa(scene, cam, q, t, H, W, device=dev)[0]
    grads = synth.sobel_gradients(images)
    shapes = net.param_shapes(8, 3, 8, (H, W))
    p = {k: v for k, v in net.init_params(shapes, seed, dev).items()
         if k.startswith("decoder.")}
    prx0, jac = rlm.decode(p, images, 3)
    links = [(j, i) for i in range(K) for j in range(max(0, i - 2), i)]
    pairs = [x for i, j in links for x in ((i, j), (j, i))]
    src, dst = torch.as_tensor(pairs).T
    qt = torch.as_tensor(q)
    tt = torch.as_tensor(t)
    noise = torch.randn((K, 6), generator=torch.Generator().manual_seed(seed))
    noise[:, :3] *= 0.02
    noise[:, 3:] *= 0.01
    noise[0] = 0.0
    q0, t0 = rlm.retract(qt, tt, noise)
    pr = large_map.build_problem(images, prx0, jac, torch.zeros_like(prx0),
                                 grads, SE3(q0, t0), torch.zeros((K, 8)),
                                 links)
    inp = rlm.Inputs(images, grads, prx0, jac, src, dst)
    pcam = PinholeCamera.create(*cam)
    return pr, inp, cam, pcam, cfg["sfm"], cfg["priors"]
