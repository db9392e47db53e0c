"""Reference run of the JAX package's ``parallel/`` entry points on the two
full-width problems that ``chip_smoke.py`` phase 6 drives through the
PyTorch port: the large-map bundle adjustment (``large_map.LargeMapBA``)
and the lockstep multi-scene odometry (``multi_seq.BatchedOdometry``).

Both problems are defined by the constants ``LARGE`` and ``ODO`` of
chip_smoke.py (imported from there, so the two cannot drift apart): the
synthetic rooms and the orbit by seed, the ``room256_32v4`` decoder's
outputs at 192x256 for the map's keyframes, links to the last four
keyframes both ways, poses perturbed from a numpy seed. This script builds
them with the JAX package alone, on a one-device CPU mesh, and prints the
readings from which chip_smoke.py's pass limits were set (PERF.md states
them beside the card's).

Run on the CPU, from the repository root (the large map holds about 6 GB
and takes a few minutes):
    JAX_PLATFORMS=cpu python port_tools/jax_parallel_reference.py
    JAX_PLATFORMS=cpu python port_tools/jax_parallel_reference.py --only odo
Prints one JSON line per problem. Its wall-clock numbers are CPU numbers
and say nothing about any accelerator.
"""
import argparse
import json
import os
import resource
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import chip_smoke as cs  # noqa: E402  (constants only; it imports no torch here)
from deepfactors_tpu.geometry import se3 as se3m  # noqa: E402
from deepfactors_tpu.geometry.camera import PinholeCamera  # noqa: E402
from deepfactors_tpu.geometry.se3 import SE3  # noqa: E402
from deepfactors_tpu.io import synth  # noqa: E402
from deepfactors_tpu.ops import dense_sfm as ds  # noqa: E402
from deepfactors_tpu.ops import image as ip  # noqa: E402
from deepfactors_tpu.parallel import large_map, multi_seq  # noqa: E402

H, W = cs.H, cs.W


def camera():
    return PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                                width=W, height=H)


def relative_to_first(poses):
    inv0 = se3m.inverse(poses[0])
    return se3m.stack([se3m.mul(inv0, p) for p in poses])


def trans_err(true: SE3, est: SE3):
    e = np.asarray(jax.vmap(se3m.local)(true, est))[:, :3]
    return np.linalg.norm(e, axis=-1)


def run_large_map():
    from deepfactors_tpu.models.decoder import (Decoder, NetworkConfig,
                                                load_params)
    c = cs.LARGE
    cam = camera()
    prefix = os.path.join(ROOT, "data", "nets", "room256_32v4")
    with open(prefix + ".json") as f:
        nj = json.load(f)
    decoder = Decoder(NetworkConfig(
        code_size=nj["code_size"], pyramid_levels=nj["pyramid_levels"],
        input_width=nj["input_width"], input_height=nj["input_height"],
        avg_dpt=nj["avg_dpt"], base_ch=nj.get("base_ch", 32),
        pred_head=nj.get("pred_head", "gap")), params=load_params(prefix + ".pkl"))
    scene = synth.random_room(c["scene_seed"], n_boxes=3)
    poses = synth.orbit_trajectory(cs.SEQ_LEN, sweep=3.2 * np.pi)
    poses = poses[::c["stride"]][:c["K"]]
    imgs = synth.render_sequence(scene, cam, poses, H, W)
    prx0, jac, std = [], [], []
    for im in imgs:
        out = decoder.raw_outputs(jnp.asarray(im))
        # the predicted code folded into the zero-code proximity, as the
        # mapper does at keyframe build
        prx0.append(out["prx0"][0] + jnp.einsum("hwc,c->hw", out["jac"][0],
                                                out["code_pred"]))
        jac.append(out["jac"][0])
        std.append(out["stdev"][0])
    images = jnp.asarray(np.stack(imgs))
    true = relative_to_first(poses)
    poses0 = jax.vmap(se3m.retract)(true, jnp.asarray(cs.large_map_noise()))
    K, CS = c["K"], nj["code_size"]
    mesh = Mesh(np.array(jax.devices()[:1]), ("factors",))
    problem = large_map.build_problem(
        mesh, "factors", images, jnp.stack(prx0), jnp.stack(jac),
        jnp.stack(std), jax.vmap(ip.sobel_gradients)(images), poses0,
        jnp.zeros((K, CS)), cs.large_map_links())
    ba = large_map.LargeMapBA(mesh, "factors", K, CS, cam,
                              ds.SfmParams(**cs.LARGE_SFM))
    t0 = time.perf_counter()
    est, codes, hist = ba.run(problem, iters=c["iters"])
    wall = time.perf_counter() - t0
    hist = np.asarray(jnp.stack(hist))
    e0, e1 = trans_err(true, poses0), trans_err(true, est)
    # the decoder's depth carries a scale bias that a monocular BA cannot
    # see: the error left after one scale factor on the translations
    tt, te = np.asarray(true.t), np.asarray(est.t)
    scale = float((te * tt).sum() / (te * te).sum())
    return {"problem": "large_map", "factors": int(problem.fd.src.shape[0]),
            "scale": scale,
            "scaled_trans_err_rmse_m": float(np.sqrt(
                ((scale * te - tt) ** 2).sum(axis=1).mean())),
            "trans_err_rmse_m": [float(np.sqrt((e0 ** 2).mean())),
                                 float(np.sqrt((e1 ** 2).mean()))],
            "trans_err_max_m": [float(e0.max()), float(e1.max())],
            "residual_per_inlier": (hist[:, 0] / hist[:, 1]).tolist(),
            "inliers": hist[:, 1].tolist(),
            "max_abs_code": float(jnp.abs(codes).max()),
            "cpu_wall_s": wall, "platform": jax.devices()[0].platform}


def run_odometry():
    c = cs.ODO
    cam = camera()
    poses = synth.orbit_trajectory(cs.SEQ_LEN, sweep=c["sweep"])[:c["frames"] + 1]
    true = relative_to_first(poses)
    frames, depth0 = [], []
    for seed in c["scene_seeds"]:
        scene = synth.random_room(seed, n_boxes=3)
        imgs, dpts = synth.render_sequence(scene, cam, poses, H, W,
                                           with_depth=True)
        frames.append(np.stack(imgs))
        depth0.append(dpts[0])
    frames = np.stack(frames, axis=1)                    # [F + 1, S, H, W]
    odo = multi_seq.BatchedOdometry(
        cam, levels=c["levels"], iters_per_level=c["iters_per_level"],
        huber=c["huber"], kf_dist_threshold=c["kf_dist"])
    t0 = time.perf_counter()
    state = odo.init(jnp.asarray(frames[0]), jnp.asarray(np.stack(depth0)))
    errs, switches = [], []
    for i in range(1, c["frames"] + 1):
        state, pose_wc, sw = odo.process(state, jnp.asarray(frames[i]))
        errs.append(np.linalg.norm(
            np.asarray(pose_wc.t) - np.asarray(true.t[i])[None], axis=-1))
        switches.append(np.asarray(sw))
    wall = time.perf_counter() - t0
    rmse = np.sqrt((np.stack(errs) ** 2).mean(axis=0))
    return {"problem": "multi_seq", "scenes": len(c["scene_seeds"]),
            "frames": c["frames"], "trans_rmse_m_per_scene": rmse.tolist(),
            "trans_rmse_m_max": float(rmse.max()),
            "final_err_m_per_scene": errs[-1].tolist(),
            "switches_per_scene": np.stack(switches).sum(axis=0).tolist(),
            "path_length_m": float(np.linalg.norm(
                np.diff(np.asarray(true.t), axis=0), axis=-1).sum()),
            "cpu_wall_s": wall, "platform": jax.devices()[0].platform}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("large", "odo"))
    args = ap.parse_args()
    runs = [f for name, f in (("odo", run_odometry), ("large", run_large_map))
            if args.only in (None, name)]
    for run in runs:
        out = run()
        out["peak_rss_gib"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
