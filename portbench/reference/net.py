"""Plain forward pass of the depth network of room256_32v4's recipe: the
U-Net decoder with its convolutional code head, and the training encoder.

Written from the architecture as the network's JSON states it
(``data/nets/room256_32v4.json``: code size 32, 3 levels, base width 32,
``pred_head`` conv, 192x256) and from the numerics the configuration
states: every convolution takes bfloat16 operands and accumulates in fp32,
its bias is added in bfloat16; activations are tanh-approximated GELU in
bfloat16; SAME padding puts ``pad // 2`` before and the rest after;
upsampling is nearest-neighbour; the decoder's code head and the heads of
each level compute in bfloat16 and are read in fp32; the encoder's global
mean sums in fp32 and rounds to bfloat16, and its two dense heads compute
in fp32. ``init_params`` draws flax's default initialisation from a seed:
the weights both sides start from where no file gives them. Parameters
are a flat dict ``{name: tensor}`` under the flax
module names (``decoder.ConvBlock_0.Conv_0.weight``, conv weights
[Cout, Cin, 3, 3], dense kernels [in, out]).

``quantise`` selects the operands' precision: ``None`` is the stated
bfloat16; ``"fp8"`` rounds each operand of every convolution to float8
e4m3 with one scale a tensor, the gradients passing through unrounded (the
control). Imports nothing of the program.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BF16 = torch.bfloat16
E4M3_MAX = 448.0
ENCODER_CH = 32     # the training encoder keeps its own width


def _fp8(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in bf16;
    the gradient passes straight through (the rounding is held)."""
    xd = x.detach()
    s = E4M3_MAX / xd.abs().amax().float().clamp(min=1e-12)
    q = ((xd.float() * s).to(torch.float8_e4m3fn).float() / s).to(BF16)
    return x + (q - xd)


def gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


def conv(p: dict, name: str, x: Tensor, stride: int = 1,
         quantise=None) -> Tensor:
    w = p[name + ".weight"]
    k = w.shape[-1]
    H, W = x.shape[-2:]
    ph = max((-(-H // stride) - 1) * stride + k - H, 0)
    pw = max((-(-W // stride) - 1) * stride + k - W, 0)
    x = F.pad(x.to(BF16), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    wb = w.to(BF16)
    if quantise == "fp8":
        x, wb = _fp8(x), _fp8(wb)
    y = F.conv2d(x, wb, stride=stride)
    return y + p[name + ".bias"].to(BF16)[:, None, None]


def block(p, name, x, quantise=None):
    x = gelu(conv(p, name + ".Conv_0", x, 1, quantise))
    return gelu(conv(p, name + ".Conv_1", x, 1, quantise))


def dense(p, name, x, dtype):
    return x.to(dtype) @ p[name + ".kernel"].to(dtype) + \
        p[name + ".bias"].to(dtype)


def param_shapes(code_size=32, levels=3, base_ch=32, hw=(192, 256)):
    """Every leaf of the decoder (conv code head) and the encoder (its own
    base width, ``ENCODER_CH``), in order: {name: shape}."""
    shapes = OrderedDict()

    def add_conv(name, cin, cout):
        shapes[name + ".weight"] = (cout, cin, 3, 3)
        shapes[name + ".bias"] = (cout,)

    def add_block(name, cin, ch):
        add_conv(name + ".Conv_0", cin, ch)
        add_conv(name + ".Conv_1", ch, ch)

    d = "decoder."
    ch, cin, skips = base_ch, 1, []
    for lvl in range(levels):
        add_block(f"{d}ConvBlock_{lvl}", cin, ch)
        skips.append(ch)
        add_conv(f"{d}Conv_{lvl}", ch, 2 * ch)
        cin, ch = 2 * ch, min(2 * ch, 8 * base_ch)
    add_block(f"{d}ConvBlock_{levels}", cin, ch)
    add_conv(f"{d}Conv_{levels}", ch, ch)
    add_conv(f"{d}Conv_{levels + 1}", ch, 64)
    h, w = hw
    for _ in range(levels + 2):
        h, w = -(-h // 2), -(-w // 2)
    shapes[d + "code_head_conv.kernel"] = (64 * h * w, code_size)
    shapes[d + "code_head_conv.bias"] = (code_size,)
    x_ch = ch
    for i, lvl in enumerate(reversed(range(levels))):
        add_block(f"{d}ConvBlock_{levels + 1 + i}", x_ch + skips[lvl],
                  skips[lvl])
        x_ch = skips[lvl]
        add_conv(f"{d}Conv_{levels + 2 + i}", x_ch, code_size + 2)
    e = "encoder."
    ch, cin = ENCODER_CH, 2
    for i in range(4):
        nxt = min(2 * ch, 4 * ENCODER_CH)
        add_block(f"{e}ConvBlock_{i}", cin, ch)
        add_conv(f"{e}Conv_{i}", ch, nxt)
        cin = ch = nxt
    for i in range(2):
        shapes[f"{e}Dense_{i}.kernel"] = (ch, code_size)
        shapes[f"{e}Dense_{i}.bias"] = (code_size,)
    return shapes


def init_params(shapes: dict, seed: int, device) -> dict:
    """flax's defaults from the seed, on the device: every kernel a normal
    truncated to [-2, 2] over its fan-in's sqrt (all kernels in one draw),
    every bias zero."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63 + 1)
    kernels = [k for k in shapes if not k.endswith("bias")]
    n = sum(int(np.prod(shapes[k])) for k in kernels)
    flat = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k.endswith("bias"):
            out[k] = torch.zeros(shape, device=device)
            continue
        size = int(np.prod(shape))
        fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        out[k] = flat[at:at + size].reshape(shape) * std
        at += size
    return out


def decoder_forward(p: dict, img: Tensor, levels: int = 3, quantise=None):
    """img [B, H, W] -> dict of level lists, finest first: prx0 [B, H_l,
    W_l], jac [B, CS, H_l, W_l], stdev [B, H_l, W_l]; code_pred [B, CS]
    (fp32)."""
    d = "decoder."
    B = img.shape[0]
    x = img[:, None].to(BF16)
    skips = []
    for lvl in range(levels):
        x = block(p, f"{d}ConvBlock_{lvl}", x, quantise)
        skips.append(x)
        x = gelu(conv(p, f"{d}Conv_{lvl}", x, 2, quantise))
    x = block(p, f"{d}ConvBlock_{levels}", x, quantise)
    h = gelu(conv(p, f"{d}Conv_{levels}", x, 2, quantise))
    h = gelu(conv(p, f"{d}Conv_{levels + 1}", h, 2, quantise))
    h = h.permute(0, 2, 3, 1).reshape(B, -1)
    code_pred = dense(p, d + "code_head_conv", h, BF16).float()
    prx0, jac, std = [], [], []
    for i, lvl in enumerate(reversed(range(levels))):
        skip = skips[lvl]
        x = F.interpolate(x, size=skip.shape[-2:], mode="nearest-exact")
        x = block(p, f"{d}ConvBlock_{levels + 1 + i}",
                  torch.cat([x, skip], dim=1), quantise)
        head = conv(p, f"{d}Conv_{levels + 2 + i}", x, 1, quantise).float()
        prx0.insert(0, torch.sigmoid(head[:, 0]))
        std.insert(0, head[:, 1])
        jac.insert(0, 0.01 * head[:, 2:])
    return {"prx0": prx0, "jac": jac, "stdev": std, "code_pred": code_pred}


def encoder_forward(p: dict, img: Tensor, prox: Tensor, quantise=None):
    """(mu, logvar) [B, CS] of q(code | image, proximity)."""
    e = "encoder."
    x = torch.stack([img, prox], dim=1).to(BF16)
    for i in range(4):
        x = block(p, f"{e}ConvBlock_{i}", x, quantise)
        x = gelu(conv(p, f"{e}Conv_{i}", x, 2, quantise))
    gap = x.float().mean(dim=(2, 3)).to(BF16).float()
    mu = dense(p, e + "Dense_0", gap, torch.float32)
    logvar = dense(p, e + "Dense_1", gap, torch.float32).clamp(-8.0, 4.0)
    return mu, logvar


def load_decoder_params(path: str, device) -> dict:
    """The decoder's leaves from a pickled JAX-layout tree of numpy arrays
    (``data/nets/*.pkl``): conv kernels [kh, kw, Cin, Cout] become
    [Cout, Cin, kh, kw], under ``decoder.``-prefixed names."""
    import pickle
    with open(path, "rb") as f:
        tree = pickle.load(f)
    tree = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel" and a.ndim == 4:
                out[prefix + "weight"] = torch.as_tensor(
                    np.ascontiguousarray(a.transpose(3, 2, 0, 1)),
                    device=device)
            else:
                out[prefix + k] = torch.as_tensor(np.array(a), device=device)

    walk(tree, "decoder.")
    return out
