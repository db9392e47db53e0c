"""Driver of the large map: ``parallel/large_map.LargeMapBA`` refining a
whole map of decoded keyframes, solve after solve.

Set-up renders every ``stride``-th pose of the orbit of
``random_room(seed)`` as a keyframe (the benchmark's own renderer), takes
Sobel gradients (its own filter), decodes the keyframes with the program's
decoder from the configuration's weights (the predicted code folded into
the zero-code proximity, as the mapper does), builds the program's factor
table of links to the last ``back`` keyframes both ways, draws the starts
(the truth moved off by the configuration's noise, keyframe 0 held) and
runs ``warm_solves`` solves to warm up. The window runs solves back to
back, each from the next start, each ``iters`` iterations and ending with
its poses and codes on the host. The check runs the reference, which
decodes the keyframes itself, over a sample of the window's solves drawn
from the seed.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import synth
from portbench.harness import ROOT
from portbench.trace import span

FAULTS = ("unchanged", "half", "altered")


def _camera(cfg):
    return synth.Camera(cfg["fx"], cfg["fy"], cfg["u0"], cfg["v0"],
                        float(cfg["input_width"]), float(cfg["input_height"]))


def _links(K: int, back: int):
    return [(j, i) for i in range(K) for j in range(max(0, i - back), i)]


def _truth(cfg, K, device):
    """The keyframes' camera-to-world (q, t): in the world (numpy, for the
    renderer) and relative to keyframe 0 (on the device, the truth)."""
    from portbench.reference import largemap as ref
    q, t = synth.orbit_trajectory(cfg["orbit_frames"],
                                  sweep=cfg["orbit_sweep_pi"] * np.pi)
    q, t = q[::cfg["stride"]][:K], t[::cfg["stride"]][:K]
    if len(q) < K:
        raise ValueError(f"the orbit holds {len(q)} keyframes, not {K}")
    qd = torch.as_tensor(q, device=device)
    td = torch.as_tensor(t, device=device)
    # T_0^-1 T_i
    R0T = ref.quat_matrix(qd[:1])[0].T
    q0c = qd[:1] * torch.tensor([1.0, -1.0, -1.0, -1.0], device=device)
    qr = ref.quat_product(q0c.expand_as(qd), qd)
    tr = (td - td[:1]) @ R0T.T
    return q, t, qr / qr.norm(dim=-1, keepdim=True), tr


def setup(cfg, traffic, seed, device, log=print):
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.models.decoder import (Decoder, NetworkConfig,
                                                      load_params)
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.ops.kernels import build
    from deepfactors_tpu_torch.parallel import large_map
    from portbench.reference import largemap as ref

    t0 = time.perf_counter()
    K, H, W = traffic["K"], cfg["input_height"], cfg["input_width"]
    if device.type == "cuda":
        build.build_all()
    log(f"set-up: kernels ready, {time.perf_counter() - t0:.2f} s")
    cam = _camera(cfg)
    qw, tw, q_true, t_true = _truth(cfg, K, device)
    scene = synth.random_room(seed, n_boxes=cfg["n_boxes"])
    images = torch.empty((K, H, W), device=device)
    for a in range(0, K, 16):
        images[a:a + 16] = synth.render_aa(scene, cam, qw[a:a + 16],
                                           tw[a:a + 16], H, W,
                                           device=device)[0]
    grads = synth.sobel_gradients(images)
    net_cfg = NetworkConfig(**{k: cfg[k] for k in (
        "code_size", "pyramid_levels", "input_width", "input_height",
        "avg_dpt", "fx", "fy", "u0", "v0", "base_ch", "pred_head")})
    if cfg["weights"]:
        dec_params = None
        decoder = Decoder(net_cfg, device=device,
                          params=load_params(str(ROOT / cfg["weights"])))
    else:
        dec_params = decoder_init(cfg, seed, device)
        decoder = Decoder(net_cfg, device=device)
        decoder.module.load_state_dict(
            {k[len("decoder."):]: v for k, v in dec_params.items()})
    prx0, jac, std = [], [], []
    for a in range(0, K, 16):
        out = decoder.raw_outputs_T(images[a:a + 16])
        j = out["jac"][0]
        prx0.append(out["prx0"][0] + torch.einsum("bchw,bc->bhw", j,
                                                  out["code_pred"]))
        jac.append(j.permute(0, 2, 3, 1))
        std.append(out["stdev"][0])
    CS = cfg["code_size"]
    links = _links(K, cfg["back"])
    # starts: the truth moved off by the noise, keyframe 0 held
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n = traffic["starts"]
    noise = torch.randn((n, K, 6), generator=g, device=device)
    noise[..., :3] *= cfg["noise_t_m"]
    noise[..., 3:] *= cfg["noise_r_rad"]
    noise[:, 0] = 0.0
    starts = [ref.retract(q_true, t_true, noise[i]) for i in range(n)]
    problem = large_map.build_problem(
        images, torch.cat(prx0), torch.cat(jac), torch.cat(std),
        grads, SE3(*starts[0]), torch.zeros((K, CS), device=device), links)
    del prx0, jac, std, decoder
    log(f"set-up: keyframes rendered and decoded, factors gathered, "
        f"{time.perf_counter() - t0:.2f} s")
    pcam = PinholeCamera.create(cam.fx, cam.fy, cam.u0, cam.v0, cam.width,
                                cam.height)
    sfm = ds.SfmParams(**cfg["sfm"])
    ba = large_map.LargeMapBA(K, CS, pcam, sfm, **cfg["priors"])
    state = dict(cfg=cfg, traffic=traffic, device=device, cam=cam,
                 images=images, grads=grads, links=links, starts=starts,
                 problem=problem, ba=ba, K=K, CS=CS,
                 P=int(problem.fd.src.shape[0]), alter=None,
                 dec_params=dec_params)
    for i in range(traffic["warm_solves"]):        # warm-up, as the window
        _solve(state, i).cpu()
    log(f"set-up: warm solves done, {time.perf_counter() - t0:.2f} s")
    return state


def decoder_init(cfg, seed, device) -> dict:
    """Decoder weights from the seed where the configuration names none
    (the tests' small networks): flax's default initialisation."""
    from portbench.reference import net
    shapes = net.param_shapes(cfg["code_size"], cfg["pyramid_levels"],
                              cfg["base_ch"],
                              (cfg["input_height"], cfg["input_width"]))
    return {k: v for k, v in net.init_params(shapes, seed, device).items()
            if k.startswith("decoder.")}


def _solve(state, i):
    """Solve ``i``: the map from start ``i`` (mod the starts), on the host
    as one [K, 7 + CS] array (q, t, codes)."""
    q, t = state["starts"][i % len(state["starts"])]
    problem = state["problem"]._replace(
        pose_q=q, pose_t=t, codes=torch.zeros_like(state["problem"].codes))
    est, codes, _ = state["ba"].run(problem, iters=state["cfg"]["iters"])
    out = torch.cat([est.q, est.t, codes], dim=1)
    if state["alter"] is not None:
        out = state["alter"](out)
    return out


def window(state, seconds, max_units=None, traced=False):
    """Solves back to back until ``seconds`` have passed (or ``max_units``
    solves are done): ba_iter_ms is the time to the end of the last solve
    over the iterations done."""
    iters = state["cfg"]["iters"]
    done, ends = [], []
    t0 = time.perf_counter()
    while True:
        with span("solve", traced):
            out = _solve(state, len(done))
        with span("readback", traced):
            done.append(out.cpu().numpy())
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds or (max_units and len(done) >= max_units):
            break
    n = len(done)
    failed = sum(not np.isfinite(x).all() for x in done)
    return {"metrics": {"ba_iter_ms": 1e3 * elapsed / (n * iters)},
            "attempted": n, "failed": int(failed), "solves": done,
            "units": {"iterations": n * iters, "solves": n},
            "unit_s": np.diff([0.0] + ends).tolist()}


def shapes(state):
    cfg = state["cfg"]
    return {"K": state["K"], "P": state["P"], "CS": state["CS"],
            "H": cfg["input_height"], "W": cfg["input_width"]}


def plant(state, fault):
    """A fault under the timed path: the step returns its state unchanged;
    half of the factors left out; one keyframe's pose altered where the
    solve produces it."""
    if fault == "unchanged":
        step = state["ba"].step

        def still(q, t, c, fd, active):
            return (q, t, c) + tuple(step(q, t, c, fd, active)[3:])
        state["ba"].step = still
    elif fault == "half":
        fd = state["problem"].fd
        act = fd.active.clone()
        act[act.shape[0] // 2:] = False
        state["problem"] = state["problem"]._replace(
            fd=fd._replace(active=act))
    elif fault == "altered":
        k = state["K"] // 2

        def alter(out):
            out = out.clone()
            out[k, 4] += 0.01
            return out
        state["alter"] = alter
    else:
        raise ValueError(f"no fault {fault!r} (has {FAULTS})")


def check(state, res, reference, limits, seed, log=print):
    """The reference over ``check_solves`` of the window's solves, drawn
    from the seed. Each is solved from its start in float64 (the reference)
    and in float32 (the configuration's precision); ``h_ratio`` is the
    program's ``h_gap`` from the float64 solve over the float32 solve's,
    the latter no less than the traffic's ``h_floor``: how far the program
    lands from the reference, in units of how far float32 alone lands from
    it at that start. Its worst over the solves is compared."""
    cfg, traffic, device = state["cfg"], state["traffic"], state["device"]
    # free the program's state before the reference runs
    for k in ("problem", "ba"):
        state.pop(k, None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    inputs, picks = reference_inputs(state, reference, res, seed)
    state["inputs"], state["picks"], state["ref_solves"] = inputs, picks, {}
    worst = {}
    for i in picks:
        got = torch.as_tensor(res["solves"][i], device=device)
        ref64 = reference_solve(state, reference, inputs, i)
        system = reference.normal_equations(
            inputs, *ref64, state["cam"], cfg["sfm"], cfg["priors"])[::2]
        ref32 = reference_solve(state, reference, inputs, i, "float32")
        noise = reference.gaps(*ref32, *ref64, system=system)["h_gap"]
        state["ref_solves"][i] = (ref64, system, noise)
        g = reference.gaps(got[:, :4], got[:, 4:7], got[:, 7:], *ref64,
                           system)
        g["h_float32"] = noise
        g["h_ratio"] = g["h_gap"] / max(noise, traffic["h_floor"])
        for k, v in g.items():
            worst[k] = _worse(worst.get(k, 0.0), v)
        log(f"largemap check: solve {i}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in g.items()))
    state["readings"] = worst
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}


def _worse(a: float, b: float) -> float:
    """The larger of two gaps; NaN (a result that is not finite) wins."""
    return float("nan") if np.isnan(a) or np.isnan(b) else max(a, b)


def reference_inputs(state, reference, res, seed):
    """The reference's decode of the keyframes and the solves to check."""
    from portbench.reference import net
    cfg, device = state["cfg"], state["device"]
    params = state["dec_params"] or net.load_decoder_params(
        str(ROOT / cfg["weights"]), device)
    prx0, jac = reference.decode(params, state["images"],
                                 cfg["pyramid_levels"])
    pairs = [p for i, j in state["links"] for p in ((i, j), (j, i))]
    src, dst = torch.as_tensor(pairs, device=device).T
    inputs = reference.Inputs(state["images"], state["grads"], prx0, jac,
                              src, dst)
    n = len(res["solves"])
    rng = np.random.default_rng(int(seed) + 1)
    m = min(n, state["traffic"]["check_solves"])
    return inputs, sorted(rng.choice(n, size=m, replace=False).tolist())


def reference_solve(state, reference, inputs, i, precision="float64"):
    cfg = state["cfg"]
    q0, t0 = state["starts"][i % len(state["starts"])]
    return reference.solve(inputs, q0, t0, state["cam"], cfg["sfm"],
                           cfg["priors"], cfg["iters"], precision)


def control(state, res, reference, seed):
    """The control's readings, after ``check``: the reference in TF32
    (float32 sums and solve, TF32 products) in the program's place, on the
    solves the check took, measured as the check measures the program."""
    worst = {}
    for i in state["picks"]:
        ref64, system, noise = state["ref_solves"][i]
        low = reference_solve(state, reference, state["inputs"], i, "tf32")
        g = reference.gaps(*low, *ref64, system)
        g["h_ratio"] = g["h_gap"] / max(noise, state["traffic"]["h_floor"])
        print(f"largemap control: solve {i}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in g.items()), file=sys.stderr)
        for k, v in g.items():
            worst[k] = _worse(worst.get(k, 0.0), v)
    return worst
