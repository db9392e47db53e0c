"""Reference of one decoder training step in the JAX package, for
``chip_smoke.py`` phase 11b: the step that phase 11a runs on the card,
here through the JAX package's own ``make_train_step`` on a CPU.

The step is defined by chip_smoke.py's constants and numpy helpers
(imported from there, so the two cannot drift apart): VAEModel at
room256_32v4's width (CS 32, 3 levels, base_ch 32, the conv head) with
room256_32v4's decoder and ``encoder_tree()``'s encoder, a batch of one
view of each room of ``TRAIN_ROOMS`` rendered at 192x256 from
``train_batch_poses()`` (the JAX package's renderer), and the recipe's
optimiser (clip 1.0 + adamw under the cosine schedule). The step's key is
``PRNGKey(TRAIN_EPS_SEED)``; make_train_step splits it into one key per
sample and draws each sample's eps from it.

Prints one JSON object: the loss and its terms; the global norm of the
kernel gradients (and of all gradients, as JAX's reverse mode computes
them); the norm of each module's kernel gradients (chip_smoke.grad_groups);
and the derivative of the loss with respect to the finest head's bias
(decoder Conv_7, 34 values) in forward mode. Bias gradients are not taken
from reverse mode: on the CPU XLA sums a bf16 cotangent in bf16, so the
reverse-mode gradient of a bf16 conv's bias saturates (tests/test_torch_train.py).

Run on the CPU, from the repository root (about 3 GiB, ~3 minutes):
    JAX_PLATFORMS=cpu python port_tools/jax_train_reference.py
Its wall-clock times are CPU times and say nothing about any accelerator.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import chip_smoke as cs  # noqa: E402  (constants and numpy helpers only)
from deepfactors_tpu.geometry.camera import PinholeCamera  # noqa: E402
from deepfactors_tpu.geometry.se3 import SE3  # noqa: E402
from deepfactors_tpu.io import synth  # noqa: E402
from deepfactors_tpu.models import train_decoder as td  # noqa: E402
from deepfactors_tpu.models.decoder import load_params  # noqa: E402

H, W, CS, L = 192, 256, 32, 3
FINEST_HEAD = "Conv_7"


def batch():
    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    q, t = cs.train_batch_poses()
    imgs, dpts = [], []
    for i, room in enumerate(cs.TRAIN_ROOMS):
        img, dpt = synth.render(synth.random_room(room, 3), cam,
                                SE3(jnp.asarray(q[i]), jnp.asarray(t[i])),
                                H, W)
        imgs.append(np.asarray(img))
        dpts.append(np.asarray(dpt))
    imgs, dpts = np.stack(imgs), np.stack(dpts)
    return imgs, (2.0 / (2.0 + dpts)).astype(np.float32)


def main():
    t0 = time.time()
    hp = cs.TRAIN_HP
    dec = load_params(os.path.join(ROOT, "data", "nets", "room256_32v4.pkl"))
    params = {"params": {"decoder": dec["params"],
                         "encoder": cs.encoder_tree()}}
    model = td.VAEModel(code_size=CS, levels=L, base_ch=32, pred_head="conv")
    imgs, gts = batch()
    imgs, gts = jnp.asarray(imgs), jnp.asarray(gts)
    key = jax.random.PRNGKey(cs.TRAIN_EPS_SEED)
    tx = optax.chain(optax.clip_by_global_norm(hp["clip"]),
                     optax.adamw(optax.cosine_decay_schedule(
                         hp["lr"], hp["decay_steps"], alpha=hp["alpha"]),
                         weight_decay=hp["weight_decay"]))
    state = td.TrainState(params, tx.init(params), jnp.asarray(0))
    step = td.make_train_step(model, tx, hp["beta"],
                              distill_w=hp["distill_w"])
    _, loss, aux = step(state, imgs, gts, key)

    def loss_fn(p):       # make_train_step's loss_fn
        keys = jax.random.split(key, imgs.shape[0])
        losses, auxs = jax.vmap(lambda i, g, k: model.apply(
            p, i, g, k, hp["beta"], hp["distill_w"]))(imgs, gts, keys)
        return jnp.mean(losses), jax.tree.map(jnp.mean, auxs)

    (loss2, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    names = [".".join(k.key for k in p[1:]) for p, _ in flat]
    g = {n: np.asarray(v, np.float64) for n, (_, v) in zip(names, flat)}
    kern = [n for n in names if not n.endswith("bias")]
    groups = {k: float(np.sqrt(sum(np.sum(g[n] ** 2) for n in v)))
              for k, v in cs.grad_groups(names).items()}

    # forward-mode derivative wrt the finest head's bias
    b0 = params["params"]["decoder"][FINEST_HEAD]["bias"]

    def loss_of_bias(b):
        p = jax.tree.map(lambda x: x, params)
        p["params"]["decoder"] = dict(p["params"]["decoder"])
        p["params"]["decoder"][FINEST_HEAD] = dict(
            p["params"]["decoder"][FINEST_HEAD], bias=b)
        return loss_fn(p)[0]

    jvp = jax.jit(lambda tan: jax.jvp(loss_of_bias, (b0,), (tan,))[1])
    eye = np.eye(b0.shape[0], dtype=np.float32)
    head_bias = [float(jvp(jnp.asarray(e))) for e in eye]
    print(json.dumps({
        "loss": float(loss), "loss_grad_fn": float(loss2),
        "nll": float(aux["nll"]), "kl": float(aux["kl"]),
        "distill": float(aux["distill"]),
        "grad_norm_kernels": float(np.sqrt(sum(np.sum(g[n] ** 2)
                                               for n in kern))),
        "grad_norm_all_reverse": float(np.sqrt(sum(np.sum(v ** 2)
                                                   for v in g.values()))),
        "kernel_grad_norms": groups,
        "finest_head_bias_grad": head_bias,
        "cpu_seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
