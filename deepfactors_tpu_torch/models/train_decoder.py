"""Decoder training: a CodeSLAM-style conditional VAE over depth, PyTorch
port of ``deepfactors_tpu/models/train_decoder.py``.

    encoder(image, gt_prox)  -> q(c | I, D) = N(mu, sigma)      [training]
    decoder(image, c)        -> prox pyramid, linear in c
    loss = sum_levels Laplace-NLL(prox(c), prox_gt; b = exp(logb))
         + beta * KL(q || N(0, I))
         + distill_w * ||code_pred(I) - mu.detach()||^2

The distillation term trains the image-only code predictor that serving
uses (PredictAndDecode, decoder_network.cpp:139-229).

Numerics follow the JAX module. The encoder's convolutions are bf16 like
the decoder's; its global mean sums in fp32 and rounds to bf16, and its two
Dense layers compute in fp32. The ground truth of level l is
``jax.image.resize(..., method="linear")``, which antialiases when it
downsamples: ``F.interpolate(mode="bilinear", antialias=True)`` computes the
same triangle-kernel weights, renormalised at the border (within an fp32
ulp). The JAX step maps one model call over the batch with a key per sample
and takes the mean of the per-sample losses; here the batch runs as one
forward, each sample with its own row of ``eps``.

``OptaxAdam`` writes out the optax chain the JAX package trains with:
``clip_by_global_norm(1.0)`` then ``adam(lr)`` (``train``) or ``adamw`` with
optax's weight decay of 1e-4 under ``cosine_decay_schedule(lr, steps,
alpha=0.1)`` (``train_room_decoder``).
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .. import configure_numerics
from ..geometry import warping as wp
from ..parallel.multihost import rank_rows, world_rank
from ..utils.timing import span
from .decoder import (Conv, ConvBlock, Dense, DepthDecoder, NetworkConfig,
                      _gelu, init_flax_defaults, params_from_jax,
                      params_to_jax)

Tensor = torch.Tensor


class DepthEncoder(nn.Module):
    """q(c | image, prox): four (ConvBlock, stride-2 conv) stages over the
    (img, prox) stack, a global mean, and two Dense heads (mu, logvar)."""

    def __init__(self, code_size: int = 32, base_ch: int = 32):
        super().__init__()
        ch, cin = base_ch, 2
        for i in range(4):
            nxt = min(ch * 2, 4 * base_ch)
            setattr(self, f"ConvBlock_{i}", ConvBlock(cin, ch))
            setattr(self, f"Conv_{i}", Conv(ch, nxt, 3, 2))
            cin = ch = nxt
        self.Dense_0 = Dense(ch, code_size, torch.float32)
        self.Dense_1 = Dense(ch, code_size, torch.float32)

    def forward(self, img: Tensor, prox: Tensor):
        """img, prox [B, H, W] -> (mu, logvar) [B, CS], logvar in [-8, 4]."""
        x = torch.stack([img, prox], dim=1).to(torch.bfloat16)
        for i in range(4):
            x = getattr(self, f"ConvBlock_{i}")(x)
            x = _gelu(getattr(self, f"Conv_{i}")(x))
        gap = x.float().mean(dim=(2, 3)).to(torch.bfloat16).float()
        return self.Dense_0(gap), self.Dense_1(gap).clamp(-8.0, 4.0)


class VAEModel(nn.Module):
    """The decoder being trained and its training-only encoder. The
    encoder keeps its own width (base_ch 32), as in the JAX model."""

    def __init__(self, code_size=32, levels=4, base_ch=32, pred_head="gap",
                 input_hw=(192, 256)):
        super().__init__()
        self.code_size, self.levels = code_size, levels
        self.decoder = DepthDecoder(code_size, levels, base_ch, pred_head,
                                    input_hw)
        self.encoder = DepthEncoder(code_size)


def resize_linear(x: Tensor, hw) -> Tensor:
    """``jax.image.resize(x, hw, method="linear")`` over the last two axes
    of [B, H, W] (antialiased when downsampling; the same size is x)."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x[:, None], size=tuple(hw), mode="bilinear",
                         antialias=True, align_corners=False)[:, 0]


def vae_loss(model: VAEModel, imgs: Tensor, gts: Tensor, beta: float,
             distill_w: float = 0.1, eps: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None):
    """The batch mean of the per-sample VAE loss and of its terms.

    imgs, gts [B, H, W] (gts: ground-truth proximity); ``eps`` [B, CS] is
    the reparameterisation noise, drawn from ``generator`` when not given."""
    out = model.decoder(imgs)
    mu, logvar = model.encoder(imgs, gts)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    code = mu + torch.exp(0.5 * logvar) * eps
    nll = 0.0
    for lvl in range(model.levels):
        prx0 = out["prx0"][lvl]
        gt_l = resize_linear(gts, prx0.shape[-2:])
        prx = prx0 + torch.einsum("bchw,bc->bhw", out["jac"][lvl], code)
        b = torch.exp(out["stdev"][lvl].clamp(-6.0, 2.0))
        nll = nll + ((prx - gt_l).abs() / b + torch.log(2.0 * b)).mean(
            dim=(1, 2))
    kl = 0.5 * (torch.exp(logvar) + mu ** 2 - 1.0 - logvar).sum(-1)
    distill = ((out["code_pred"] - mu.detach()) ** 2).sum(-1)
    loss = nll + beta * kl + distill_w * distill
    return loss.mean(), {"nll": nll.mean(), "kl": kl.mean(),
                         "distill": distill.mean()}


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule, evaluated in float32."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * c
                                            / f32(decay_steps)))
        return float(f32(init_value) * (f32(1.0 - alpha) * cos + f32(alpha)))

    return schedule


class OptaxAdam(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm(clip_norm), adamw(lr, weight_decay))
    (``weight_decay=0`` is optax.adam), written out in optax's order:

    - clip: g / ||g|| * clip_norm where ||g|| >= clip_norm (no epsilon; the
      norm over every parameter of every group);
    - m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v, count += 1;
      u = (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps);
    - u += weight_decay * p (every parameter, biases too);
    - p += -lr(count before the increment) * u.

    ``lr`` is a float or a schedule of the step count. ``step()`` returns
    the global norm of the gradients before clipping (a device scalar)."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.clip_norm = clip_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        gnorm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        if self.clip_norm is not None:
            keep = gnorm < self.clip_norm
            one = torch.ones_like(gnorm)
            grads = torch._foreach_mul(
                torch._foreach_div(grads, torch.where(keep, one, gnorm)),
                torch.where(keep, one, one * self.clip_norm))
        lr_count, self.count = self.count, self.count + 1
        at = 0
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            gs, at = grads[at:at + len(ps)], at + len(ps)
            if not ps:
                continue
            b1, b2 = group["b1"], group["b2"]
            for p in ps:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mu = [self.state[p]["mu"] for p in ps]
            nu = [self.state[p]["nu"] for p in ps]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1.0 - b2))
            c1 = float(np.float32(1.0 - b1 ** self.count))
            c2 = float(np.float32(1.0 - b2 ** self.count))
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, group["eps"])
            u = torch._foreach_div(torch._foreach_div(mu, c1), den)
            if group["weight_decay"]:
                torch._foreach_add_(u, torch._foreach_mul(
                    ps, group["weight_decay"]))
            lr = group["lr"]
            lr = lr(lr_count) if callable(lr) else lr
            torch._foreach_add_(ps, torch._foreach_mul(u, -lr))
        return gnorm


def make_train_step(model: VAEModel, opt: OptaxAdam, beta: float = 1e-4,
                    distill_w: float = 0.1, group=None):
    """One training step over a batch: ``step(imgs, gts, eps=None,
    generator=None) -> (loss, aux)``, device scalars (aux: nll, kl,
    distill, and grad_norm, the global norm before clipping).

    With a ``torch.distributed`` group (the counterpart of the JAX
    ``train(mesh=)``, which shards the batch axis over devices) every rank
    steps on its own rows of a batch of B: imgs, gts [B / world, H, W],
    rank r holding rows r * B / world onwards. ``eps`` is always the whole
    batch's [B, CS] (drawn from ``generator``, seeded alike on every rank,
    when not given), of which each rank takes its rows, so a world of any
    size draws what one process draws. The gradients are summed by one
    ``all_reduce`` of a flat buffer and divided by the world size before
    the optimiser's step: the clip sees the one-process global norm and
    every rank applies the same update. The loss and its terms come back
    averaged over the group (in the same buffer). Not DDP: it would rename
    the state-dict keys under ``module.``. Three spans tile the step:
    ``train.forward`` (with eps), ``train.backward`` (with the
    ``all_reduce``) and ``train.optimiser`` (clip and AdamW)."""
    world, rank = world_rank(group)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(imgs: Tensor, gts: Tensor, eps: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None):
        with span("train.forward"):
            opt.zero_grad(set_to_none=True)
            if eps is None:
                eps = torch.randn((imgs.shape[0] * world, model.code_size),
                                  generator=generator, device=imgs.device)
            loss, aux = vae_loss(model, imgs, gts, beta, distill_w,
                                 eps[rank_rows(eps.shape[0], world, rank)])
        with span("train.backward"):
            loss.backward()
            if world > 1:
                loss, aux = _all_reduce_mean(params, loss, aux, world, group)
        with span("train.optimiser"):
            aux["grad_norm"] = opt.step()
            return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def _all_reduce_mean(params, loss, aux, world, group):
    """Replace every gradient by its mean over the group, and return the
    loss and its terms averaged: one ``all_reduce`` of one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    keys = sorted(aux)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([loss.detach()]
                                    + [aux[k].detach() for k in keys])])
    dist.all_reduce(flat, group=group)
    flat /= world
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[at], {k: flat[at + 1 + i] for i, k in enumerate(keys)}


def train(cfg: NetworkConfig, data_iter: Iterator, num_steps: int = 1000,
          lr: float = 1e-3, beta: float = 1e-4, seed: int = 0,
          log_every: int = 100, device="cuda", log=print, group=None):
    """Train from flax's default init with clip + adam; returns the decoder
    parameters in the JAX layout (for ``Decoder`` / ``save_params``) and
    the loss every ``log_every`` steps. ``data_iter`` yields (imgs, depths)
    [B, H, W] numpy arrays. The model is the JAX ``train``'s:
    ``VAEModel(cfg.code_size, cfg.pyramid_levels)``. With a
    ``torch.distributed`` group (the JAX ``mesh=``) every rank takes its
    rows of each batch (``make_train_step``); B must divide by the world
    size, and every rank reads the same ``data_iter``."""
    configure_numerics()
    dev = torch.device(device)
    model = VAEModel(cfg.code_size, cfg.pyramid_levels,
                     input_hw=(cfg.input_height, cfg.input_width))
    init_flax_defaults(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    opt = OptaxAdam(model.parameters(), lr, clip_norm=1.0)
    step_fn = make_train_step(model, opt, beta, group=group)
    gen = torch.Generator(device=dev).manual_seed(seed)
    history = []
    for i in range(num_steps):
        imgs, depths = next(data_iter)
        rows = rank_rows(imgs.shape[0], *world_rank(group))
        imgs = torch.as_tensor(imgs[rows], device=dev)
        gts = wp.depth_to_prox(torch.as_tensor(depths[rows], device=dev),
                               cfg.avg_dpt)
        loss, aux = step_fn(imgs, gts, generator=gen)
        if i % log_every == 0:
            lf = float(loss)
            history.append(lf)
            log(f"step {i}: loss={lf:.4f} nll={float(aux['nll']):.4f} "
                f"kl={float(aux['kl']):.2f}")
    return extract_decoder_params(model), history


def extract_decoder_params(model: VAEModel) -> dict:
    """The decoder's parameters in the JAX layout ``{"params": ...}``."""
    return params_to_jax(model.decoder.state_dict())


def vae_params_from_jax(params: dict) -> dict:
    """The JAX VAEModel tree ``{"params": {"decoder": ..., "encoder":
    ...}}`` -> a VAEModel state_dict (each part through
    ``params_from_jax``)."""
    tree = params.get("params", params)
    return {f"{part}.{k}": v for part in ("decoder", "encoder")
            for k, v in params_from_jax(tree[part]).items()}


def vae_params_to_jax(model: VAEModel) -> dict:
    """The inverse of ``vae_params_from_jax``."""
    return {"params": {part: params_to_jax(getattr(model, part)
                                           .state_dict())["params"]
                       for part in ("decoder", "encoder")}}


def synthetic_depth_dataset(cfg: NetworkConfig, batch: int = 4,
                            seed: int = 0):
    """Procedural (image, depth) pairs (textured slanted planes and blobs),
    host numpy: the JAX package's generator, draw for draw."""
    rng = np.random.RandomState(seed)
    H, W = cfg.input_height, cfg.input_width
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    while True:
        imgs, dpts = [], []
        for _ in range(batch):
            a, b = rng.uniform(-0.3, 0.3, 2)
            d0 = rng.uniform(1.0, 3.5)
            depth = d0 + a * (xs / W - 0.5) + b * (ys / H - 0.5)
            for _ in range(rng.randint(1, 4)):
                cy, cx = rng.randint(0, H), rng.randint(0, W)
                r = rng.uniform(8, 24)
                blob = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / r ** 2)
                depth = depth - rng.uniform(0.1, 0.6) * blob
            depth = np.clip(depth, 0.3, 8.0)
            img = (0.4 + 0.2 * np.sin(xs / rng.uniform(4, 12))
                   * np.cos(ys / rng.uniform(4, 12))
                   + 0.3 * (depth - depth.min()) / (np.ptp(depth) + 1e-6))
            imgs.append(img.astype(np.float32))
            dpts.append(depth.astype(np.float32))
        yield np.stack(imgs), np.stack(dpts)
