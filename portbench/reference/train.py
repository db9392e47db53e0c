"""Plain reference of decoder training: the first steps of room256_32v4's
recipe, step by step.

The loss of the CodeSLAM-style VAE as the recipe states it, per sample
and then the batch mean: over the decoder's levels the Laplace NLL
|prx0 + J c - gt_l| / b + log 2b with b = exp(clamp(logb, -6, 2)) and gt_l
the proximity resized linearly with antialiasing to the level; c = mu +
exp(logvar / 2) eps from the encoder; + beta KL(q || N(0, I)); + distill_w
|code_pred - mu|^2 with mu held. Gradients by autograd; then optax's chain
written out: the global norm clipped to ``clip`` (no epsilon), Adam
(b1 0.9, b2 0.999, eps 1e-8, bias correction in fp32), weight decay added
to the update, the step scaled by the cosine schedule at the count before
the increment (optax.cosine_decay_schedule). Forward numerics are
``reference/net.py``'s; ``quantise="fp8"`` runs every convolution on fp8
operands (the control). Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import net


def lr_at(count: int, hp: dict) -> float:
    c = min(count, hp["decay_steps"])
    cos = 0.5 * (1.0 + math.cos(math.pi * c / hp["decay_steps"]))
    return hp["lr"] * ((1.0 - hp["alpha"]) * cos + hp["alpha"])


def loss(p: dict, imgs, gts, eps, hp, levels, quantise=None):
    out = net.decoder_forward(p, imgs, levels, quantise)
    mu, logvar = net.encoder_forward(p, imgs, gts, quantise)
    code = mu + torch.exp(0.5 * logvar) * eps
    nll = 0.0
    for lvl in range(levels):
        prx0 = out["prx0"][lvl]
        size = tuple(prx0.shape[-2:])
        gt = gts if size == tuple(gts.shape[-2:]) else F.interpolate(
            gts[:, None], size=size, mode="bilinear", antialias=True,
            align_corners=False)[:, 0]
        prx = prx0 + (out["jac"][lvl] * code[:, :, None, None]).sum(1)
        b = torch.exp(out["stdev"][lvl].clamp(-6.0, 2.0))
        nll = nll + ((prx - gt).abs() / b + torch.log(2.0 * b)).mean((1, 2))
    kl = 0.5 * (torch.exp(logvar) + mu * mu - 1.0 - logvar).sum(-1)
    distill = ((out["code_pred"] - mu.detach()) ** 2).sum(-1)
    return (nll + hp["beta"] * kl + hp["distill_w"] * distill).mean()


def follow(init: dict, batches, hp: dict, levels: int, quantise=None):
    """The recipe's steps over ``batches`` [(imgs, gts, eps)] from the
    parameters ``init``: {"loss": [per step], "grad": {leaf: norm of the
    clipped gradient of step 1}, "raw": {leaf: norm of step 1's gradient
    before the clip}, "change": {leaf: norm of the parameters' change
    after the last step}}."""
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, e = 0.9, 0.999, 1e-8
    out = {"loss": []}
    for step, (imgs, gts, eps) in enumerate(batches):
        L = loss(p, imgs, gts, eps, hp, levels, quantise)
        g = dict(zip(p, torch.autograd.grad(L, list(p.values()))))
        out["loss"].append(float(L.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((x.double() ** 2).sum()
                                  for x in g.values())).float()
            scale = hp["clip"] / norm if norm >= hp["clip"] else 1.0
            gc = {k: x * scale for k, x in g.items()}
            if step == 0:
                out["raw"] = {k: float(x.norm()) for k, x in g.items()}
                out["grad"] = {k: float(x.norm()) for k, x in gc.items()}
            n = step + 1
            c1, c2 = 1.0 - b1 ** n, 1.0 - b2 ** n
            lr = lr_at(step, hp)
            for k in p:
                m[k].mul_(b1).add_(gc[k], alpha=1.0 - b1)
                v2[k].mul_(b2).add_(gc[k] * gc[k], alpha=1.0 - b2)
                u = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + e)
                u = u + hp["weight_decay"] * p[k]
                p[k].sub_(lr * u)
    with torch.no_grad():
        out["change"] = {k: float((p[k] - init[k].float()).norm())
                         for k in p}
    return out


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref):
    the gap of two norms a leaf, not the norm of a difference."""
    keys = [k for k in ref if keep is None or k in keep]
    vals = sorted(ref[k] for k in keys)
    med = vals[len(vals) // 2]
    gap = 0.0
    for k in keys:
        d = abs(prog[k] - ref[k]) / max(ref[k], med)
        if math.isnan(d):
            return d
        gap = max(gap, d)
    return gap
