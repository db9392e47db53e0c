"""Driver of decoder training: ``models/train_decoder.make_train_step``
with room256_32v4's recipe, step after step.

Set-up renders the dataset on the device (the benchmark's frozen copy of
the recipe's renderer, rooms from the seed), makes the initial parameters
on the device from the seed (flax's default: lecun-normal kernels, a
normal truncated at two standard deviations drawn in one call, zero
biases), loads them into the program's ``VAEModel``, builds its
``OptaxAdam`` and the step, and drives that step through its first three
steps with the window's own feed (rows of a permutation, the recipe's
augmentation and eps, all drawn on the device from the seed): the steps
that the reference follows. Their losses, step 1's gradient as the
optimiser got it (its first moment over 1 - b1) and the parameters' change
after step 3 are kept. More steps warm up. The window steps back to back,
the loss read on the host every ``log_every`` steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import recipe, synth
from portbench.trace import span

FAULTS = ("unchanged", "half", "altered")
CHECKED = 3


def _hp(cfg):
    return {k: cfg[k] for k in ("lr", "decay_steps", "alpha", "weight_decay",
                                "clip", "beta", "distill_w")}


def setup(cfg, traffic, seed, device, log=print):
    from deepfactors_tpu_torch import configure_numerics
    from deepfactors_tpu_torch.models import train_decoder as td
    from portbench.reference import net

    configure_numerics()
    t0 = time.perf_counter()
    H, W, CS = cfg["input_height"], cfg["input_width"], cfg["code_size"]
    cam = synth.Camera(cfg["fx"], cfg["fy"], cfg["u0"], cfg["v0"], float(W),
                       float(H))
    imgs, dpts = recipe.build_dataset(
        cfg["rooms"], cfg["poses_per_room"], H, W, cam, seed=seed,
        randomize=cfg["randomize"], scale_range=tuple(cfg["scale_range"]),
        device=device)
    gts = cfg["avg_dpt"] / (cfg["avg_dpt"] + dpts)
    del dpts
    log(f"set-up: dataset {imgs.shape[0]} views, "
        f"{time.perf_counter() - t0:.2f} s")
    shapes = net.param_shapes(CS, cfg["pyramid_levels"], cfg["base_ch"],
                              (H, W))
    init = net.init_params(shapes, seed, device)
    model = td.VAEModel(CS, cfg["pyramid_levels"], cfg["base_ch"],
                        cfg["pred_head"], (H, W))
    model.load_state_dict(init, strict=True)
    model.to(device).train()
    hp = _hp(cfg)
    opt = td.OptaxAdam(model.parameters(),
                       td.cosine_decay_schedule(hp["lr"], hp["decay_steps"],
                                                hp["alpha"]),
                       weight_decay=hp["weight_decay"], clip_norm=hp["clip"])
    step = td.make_train_step(model, opt, hp["beta"], hp["distill_w"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    B = traffic["batch"]
    state = dict(cfg=cfg, traffic=traffic, device=device, model=model,
                 opt=opt, step=step, gen=gen, imgs=imgs, gts=gts,
                 sampler=recipe.EpochSampler(imgs.shape[0], B, gen, device),
                 augment=recipe.make_augment(cfg["aug_strength"]) if
                 cfg["randomize"] else None, init=init, batch=B, hp=hp,
                 mangle=None)
    # the checked steps: the window's own call and feed
    names = [n for n, _ in model.named_parameters()]
    batches, losses = [], []
    for i in range(CHECKED):
        feed = _feed(state)
        batches.append(feed)
        loss = _step(state, feed)
        losses.append(loss)
        if i == 0:
            b1 = opt.param_groups[0]["b1"]
            grad = {n: (opt.state[p]["mu"] / (1.0 - b1)).norm()
                    for n, p in model.named_parameters()}
    change = {n: (p.detach() - init[n]).norm()
              for n, p in model.named_parameters()}
    log(f"set-up: checked steps done, {time.perf_counter() - t0:.2f} s")
    state["checked"] = dict(
        batches=batches, loss=[float(x) for x in losses],
        grad={n: float(grad[n]) for n in names},
        change={n: float(change[n]) for n in names})
    for _ in range(traffic["warm_steps"]):
        _step(state, _feed(state))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"set-up: warm steps done, {time.perf_counter() - t0:.2f} s")
    return state


def _feed(state):
    """The next batch: (augmented images, proximity, eps)."""
    idx = state["sampler"].next()
    imgs = state["imgs"][idx]
    if state["augment"] is not None:
        imgs = state["augment"](imgs, state["gen"])
    eps = torch.randn((state["batch"], state["cfg"]["code_size"]),
                      generator=state["gen"], device=state["device"])
    return imgs, state["gts"][idx], eps


def _step(state, feed):
    imgs, gts, eps = feed
    if state["mangle"] is not None:
        imgs, gts, eps = state["mangle"](imgs, gts, eps)
    loss, _ = state["step"](imgs, gts, eps=eps)
    return loss


def window(state, seconds, max_units=None, traced=False):
    """Steps back to back until ``seconds`` have passed (or ``max_units``
    steps are done), the loss read every ``log_every`` steps; images a
    second over the window's elapsed time, to the end of the last step."""
    every = state["cfg"]["log_every"]
    dev = state["device"]
    losses, ends = [], []
    t0 = time.perf_counter()
    n = 0
    while True:
        with span("step", traced):
            loss = _step(state, _feed(state))
        losses.append(loss)
        if n % every == 0:
            with span("readback", traced):
                float(loss)
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds or (max_units and n >= max_units):
            break
    with span("readback", traced):
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    return {"metrics": {"train_images_per_s": n * state["batch"] / elapsed},
            "attempted": n, "failed": bad, "units": {"steps": n},
            "unit_s": np.diff([0.0] + ends).tolist()}


def shapes(state):
    cfg = state["cfg"]
    return {"batch": state["batch"], "CS": cfg["code_size"],
            "levels": cfg["pyramid_levels"], "base_ch": cfg["base_ch"],
            "H": cfg["input_height"], "W": cfg["input_width"]}


def plant(state, fault):
    """A fault under the timed path, planted before the checked steps are
    taken again: the optimiser's step leaves the parameters unchanged; the
    loss over half of the batch; one leaf's gradient doubled where the
    backward pass produces it."""
    opt, model = state["opt"], state["model"]
    if fault == "unchanged":
        step = opt.step

        def still(closure=None):
            saved = [p.detach().clone() for p in model.parameters()]
            g = step(closure)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return g
        opt.step = still
    elif fault == "half":
        half = state["batch"] // 2
        state["mangle"] = lambda i, g, e: (i[:half], g[:half], e[:half])
    elif fault == "altered":
        p = next(iter(model.parameters()))
        p.register_hook(lambda g: 2.0 * g)
    else:
        raise ValueError(f"no fault {fault!r} (has {FAULTS})")
    _retake(state)


def _retake(state):
    """Take the checked steps again from the initial parameters, a fresh
    optimiser state and the same batches, with the fault in place."""
    model, opt = state["model"], state["opt"]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state["init"][n])
    opt.state.clear()
    opt.count = 0
    names = [n for n, _ in model.named_parameters()]
    losses = []
    for i, feed in enumerate(state["checked"]["batches"]):
        losses.append(float(_step(state, feed)))
        if i == 0:
            b1 = opt.param_groups[0]["b1"]
            grad = {n: float((opt.state[p]["mu"] / (1.0 - b1)).norm())
                    if opt.state[p] else 0.0
                    for n, p in model.named_parameters()}
    state["checked"].update(
        loss=losses, grad=grad,
        change={n: float((p.detach() - state["init"][n]).norm())
                for n, p in zip(names, model.parameters())})


def check(state, res, reference, limits, seed, log=print, quantise=None):
    """The reference follows the checked steps: the worst step's loss gap,
    the worst leaf's gap of step 1's gradient norm and of the change's
    norm after the last step (leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change)."""
    got = state["checked"]
    for k in ("model", "opt", "step", "imgs", "gts", "sampler"):
        state.pop(k, None)
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(state, reference, quantise)
    g = compare(got, ref, reference)
    log("train check: " + ", ".join(f"{k} {v:.3e}" for k, v in g.items()))
    return {k: {"value": g[k], "limit": limits[k]} for k in limits}


def reference_readings(state, reference, quantise=None):
    return reference.follow(state["init"], state["checked"]["batches"],
                            state["hp"], state["cfg"]["pyramid_levels"],
                            quantise)


def compare(got: dict, ref: dict, reference) -> dict:
    raw = sorted(ref["raw"].values())
    floor = 1e-3 * raw[len(raw) // 2]
    moving = {k for k, v in ref["raw"].items() if v >= floor}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       ref["loss"]))
    if any(np.isnan(a) for a in got["loss"]):
        loss_gap = float("nan")
    return {"loss_gap": loss_gap,
            "grad_gap": reference.worst_leaf_gap(got["grad"], ref["grad"]),
            "update_gap": reference.worst_leaf_gap(got["change"],
                                                   ref["change"], moving)}


def control(state, res, reference, seed):
    """The control's readings: the reference on fp8 convolution operands in
    the program's place, against the reference."""
    ref = reference_readings(state, reference)
    low = reference_readings(state, reference, quantise="fp8")
    return compare(low, ref, reference)
