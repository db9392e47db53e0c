"""What ``se3_gram_batch(plan_p=)`` costs the scene-split odometry.

chip_smoke.py's 13d splits 6c's odometry (the 8 rooms of ``ODO``, 30
frames, 3 levels at 192x256) over 2 ranks of 4 rooms. Each rank launches
``se3_gram_batch`` at P = 4 with the launch plan of P = 8
(``BatchedOdometry`` passes ``plan_p=S``), so that each room's sums run in
one process's order and the poses equal one process's bit for bit. Its own
plan would take fewer pixels a thread and twice the blocks. This times
both plans in every rank of a world of 2: NCCL with a card a rank where the
machine has two cards or more, else gloo with both ranks on cuda:0 (the
ranks then share the card, and the times say less).

Each rank runs the whole odometry ``--reps`` times under each plan, in the
order ABBA..., and reads per run the median host ms per lockstep frame
(synchronised around ``process``, the gather included); then the device
ms of one ``se3_gram_batch`` launch at each level's shape (P = 4, CUDA
events over back-to-back launches, ``chip_smoke.cuda_ms``) under each
plan; and how far the two plans' poses part. Prints one line per rank and
a JSON line of every number, with the card's name and power limit.

Run from the repository root on a machine with a GPU (two or more cards
for the NCCL reading):
    python3 port_tools/odometry_plan_cost.py [--reps 3]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "odometry_plan_cost")
WORLD = 2


def _own_plan(sg):
    """``se3_gram_batch`` with ``plan_p`` dropped: the kernel takes the plan
    of the P it is given."""
    orig = sg.se3_gram_batch

    def call(*a, plan_p=None, **k):
        return orig(*a, **k)
    return orig, call


def odometry_ms(cs, setup, group, own_plan):
    """One run of 6c's odometry over this rank's rooms: the poses [n, S, 7]
    and the host ms of every lockstep frame."""
    import numpy as np
    import torch
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg
    from deepfactors_tpu_torch.parallel import multi_seq

    c = cs.ODO
    orig, call = _own_plan(sg)
    if own_plan:
        sg.se3_gram_batch = call
    try:
        odo = multi_seq.BatchedOdometry(
            setup["cam"], levels=c["levels"],
            iters_per_level=c["iters_per_level"], huber=c["huber"],
            kf_dist_threshold=c["kf_dist"], group=group)
        frames = setup["frames"]
        state = odo.init(frames[0], setup["depth0"])
        ms, poses = [], []
        for i in range(1, frames.shape[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, pose, _ = odo.process(state, frames[i])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            poses.append(torch.cat([pose.q, pose.t], -1).cpu().numpy())
    finally:
        sg.se3_gram_batch = orig
    return np.stack(poses), ms


def launch_ms(cs, setup, rows, plan_p):
    """Device ms of one se3_gram_batch launch over this rank's rooms at
    each level of the pyramid (the odometry's shapes), first frame against
    the second, with the plan of ``plan_p`` (None: its own)."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import camera_pyramid
    from deepfactors_tpu_torch.ops import image as ip
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    c = cs.ODO
    frames = setup["frames"]
    kf = ip.build_pyramid(frames[0][rows], c["levels"])
    live = ip.build_pyramid(frames[1][rows], c["levels"])
    grads = ip.build_gradient_pyramid(live)
    dpt = [setup["depth0"][rows]]
    for _ in range(c["levels"] - 1):
        dpt.append(dpt[-1][:, ::2, ::2].contiguous())
    P = kf[0].shape[0]
    slot = torch.arange(P, dtype=torch.int32, device=frames.device)
    pose = se3m.identity((P,), device=frames.device)
    out = []
    for level, cam in enumerate(camera_pyramid(setup["cam"], c["levels"])):
        kp = sg.make_sfm_params(pose, cam, 1, 0.0, c["huber"], 2.0)
        gx = grads[level][..., 0].contiguous()
        gy = grads[level][..., 1].contiguous()
        out.append(cs.cuda_ms(lambda: sg.se3_gram_batch(
            kp, slot, slot, kf[level], dpt[level], live[level], gx, gy,
            grad_mode="sampled", plan_p=plan_p), iters=50))
    return out


def rank_main(args):
    import numpy as np
    import torch
    import chip_smoke as cs
    from deepfactors_tpu_torch.parallel import multihost

    multihost.initialize(args.coord, args.nproc, args.proc_id,
                         backend=args.backend, device="cuda")
    try:
        dev = multihost.local_device()
        group = multihost.global_group()
        data = torch.load(args.data, weights_only=False)
        setup = dict(cam=cs._smoke_camera(), frames=data["frames"].to(dev),
                     depth0=data["depth0"].to(dev))
        S = setup["frames"].shape[1]
        world, rank = multihost.world_rank(group)
        rows = multihost.rank_rows(S, world, rank)
        odometry_ms(cs, setup, group, False)                    # warm-up
        runs = {"plan_of_S": [], "own_plan": []}
        poses = {}
        for i in range(2 * args.reps):
            own = (i % 4) in (1, 2)                             # ABBA
            p, ms = odometry_ms(cs, setup, group, own)
            key = "own_plan" if own else "plan_of_S"
            runs[key].append(float(np.median(ms)))
            poses.setdefault(key, p)
        kernel = {"plan_of_S": launch_ms(cs, setup, rows, S),
                  "own_plan": launch_ms(cs, setup, rows, None)}
        res = dict(rank=rank, device=str(dev), P=S // world, S=S,
                   frame_ms=runs, launch_ms=kernel,
                   pose_diff=float(np.abs(poses["own_plan"]
                                          - poses["plan_of_S"]).max()))
        with open(f"{args.out}.rank{args.proc_id}.json", "w") as f:
            json.dump(res, f)
    finally:
        multihost.shutdown()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    for flag in ("--data", "--out", "--backend", "--coord"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--nproc", "--proc-id"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        return rank_main(args)
    import torch
    if not torch.cuda.is_available():
        print("odometry_plan_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch.ops.kernels import build
    from deepfactors_tpu_torch.parallel import multihost

    smi = cs.smi_line()
    build.build_all()                       # the ranks only load the .so
    setup = cs.odometry_setup("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    data = os.path.join(OUT_DIR, "data.pt")
    torch.save({"frames": setup["frames"].cpu(),
                "depth0": setup["depth0"].cpu()}, data)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= WORLD else "gloo"
    out = os.path.join(OUT_DIR, "ranks")
    outs = multihost.World(
        [sys.executable, os.path.abspath(__file__), "--rank", "--data", data,
         "--out", out, "--backend", backend, "--reps", str(args.reps)],
        WORLD).wait(600)
    for r, (rc, o) in enumerate(outs):
        if rc != 0:
            print(f"rank {r} exited {rc}:\n{o}", file=sys.stderr)
            return 1
    ranks = []
    for r in range(WORLD):
        with open(f"{out}.rank{r}.json") as f:
            ranks.append(json.load(f))
    for x in ranks:
        print(f"rank {x['rank']} on {x['device']} (P = {x['P']} of S = "
              f"{x['S']}): median ms per lockstep frame, per run, with the "
              f"plan of S {x['frame_ms']['plan_of_S']}, with its own plan "
              f"{x['frame_ms']['own_plan']}; one se3_gram_batch launch per "
              f"level (device ms) plan of S {x['launch_ms']['plan_of_S']}, "
              f"own plan {x['launch_ms']['own_plan']}; the poses of the two "
              f"plans part by {x['pose_diff']:.3e}")
    print(json.dumps({"backend": backend, "world": WORLD, "cards": cards,
                      "card": smi, "ranks": ranks}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
