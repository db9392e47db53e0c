"""Latent-code depth decoder network (CodeSLAM-style U-Net), PyTorch port
of ``deepfactors_tpu/models/decoder.py``.

The network is linear in the code by construction: each pyramid level emits

    prx_l(I, c) = prx0_l(I) + B_l(I) @ c

with the zero-code proximity ``prx0_l`` (sigmoid-bounded), the code basis
``B_l`` ([H, W, CS], the exact d prx / d code) and the log-uncertainty
``logb_l`` as outputs, plus a code predicted from the image
(PredictAndDecode, decoder_network.cpp:139-229).

Numerics follow the JAX module: activations and convolution outputs are
bfloat16 (accumulated in fp32 by the convolution, rounded to bf16, bias
added in bf16), heads are cast to fp32. The JAX ``Conv`` pads SAME as
``pad // 2`` top/left and the rest bottom/right — with stride 2 on even
sizes that is 0 top and 1 bottom, unlike PyTorch's symmetric padding — so
padding is explicit here. flax's ``nn.gelu`` is the tanh approximation.
Upsampling is nearest-neighbour. The checkpoint is a plain pickled dict of
numpy arrays; ``params_from_jax`` maps its tree (kernels [kh, kw, Cin,
Cout], flax auto-numbered module names) onto this module's state_dict.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import configure_numerics

Tensor = torch.Tensor


class NetworkConfig(NamedTuple):
    """Mirror of the reference JSON network config
    (decoder_network.cpp:231-325)."""

    code_size: int = 32
    pyramid_levels: int = 4
    input_width: int = 256
    input_height: int = 192
    avg_dpt: float = 2.0
    fx: float = 0.0
    fy: float = 0.0
    u0: float = 0.0
    v0: float = 0.0
    grayscale: bool = True
    base_ch: int = 32
    pred_head: str = "gap"   # "gap" | "conv" (spatial code predictor)


class DecodeResult(NamedTuple):
    """One entry per pyramid level, finest first (shapes [H_l, W_l, ...])."""

    prx: tuple        # proximity at the given code
    prx0: tuple       # zero-code proximity
    jac: tuple        # [H_l, W_l, CS] code Jacobian (basis)
    stdev: tuple      # log-b uncertainty
    code: Tensor      # the code used / predicted [CS]


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


class Conv(nn.Module):
    """3x3 (or kxk) SAME convolution with the JAX package's padding split
    and bf16 numerics. Weight stored [Cout, Cin, kh, kw]."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: Tensor) -> Tensor:
        H, W = x.shape[-2:]
        s, k = self.stride, self.k
        pad_h = max((-(-H // s) - 1) * s + k - H, 0)
        pad_w = max((-(-W // s) - 1) * s + k - W, 0)
        x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2,
                      pad_h // 2, pad_h - pad_h // 2))
        y = F.conv2d(x.to(torch.bfloat16), self.weight.to(torch.bfloat16),
                     stride=s)
        return y + self.bias.to(torch.bfloat16)[:, None, None]


class ConvBlock(nn.Module):
    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.Conv_0 = Conv(cin, ch)
        self.Conv_1 = Conv(ch, ch)

    def forward(self, x):
        return _gelu(self.Conv_1(_gelu(self.Conv_0(x))))


class Dense(nn.Module):
    """flax nn.Dense in bf16: kernel stored [in, out]."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        y = x.to(torch.bfloat16) @ self.kernel.to(torch.bfloat16)
        return y + self.bias.to(torch.bfloat16)


class DepthDecoder(nn.Module):
    """U-Net producing (prx0, code basis, logb) pyramids + a predicted code.
    Submodule names follow the flax auto-numbering of the JAX module
    (ConvBlock_i, Conv_i, code_head(_conv)), so the checkpoint maps by name.

    ``forward(img [H, W])`` returns feature-major outputs: prx0/stdev
    [H_l, W_l], jac [CS, H_l, W_l], code_pred [CS] (fp32)."""

    def __init__(self, code_size=32, levels=4, base_ch=32, pred_head="gap",
                 input_hw=(192, 256)):
        super().__init__()
        self.code_size, self.levels, self.pred_head = code_size, levels, pred_head
        n_block = n_conv = 0

        def block(cin, ch):
            nonlocal n_block
            setattr(self, f"ConvBlock_{n_block}", ConvBlock(cin, ch))
            n_block += 1

        def conv(cin, cout, s=1):
            nonlocal n_conv
            setattr(self, f"Conv_{n_conv}", Conv(cin, cout, 3, s))
            n_conv += 1

        ch, cin, skip_ch = base_ch, 1, []
        for _ in range(levels):
            block(cin, ch)
            skip_ch.append(ch)
            conv(ch, ch * 2, 2)
            cin = ch * 2
            ch = min(ch * 2, 8 * base_ch)
        block(cin, ch)       # bottleneck
        H, W = input_hw
        if pred_head == "conv":
            conv(ch, ch, 2)
            conv(ch, 64, 2)
            h, w = H >> (levels + 2), W >> (levels + 2)
            self.code_head_conv = Dense(64 * h * w, code_size)
        else:
            self.code_head = Dense(ch, code_size)
        x_ch = ch
        for lvl in reversed(range(levels)):
            block(x_ch + skip_ch[lvl], skip_ch[lvl])
            x_ch = skip_ch[lvl]
            conv(x_ch, code_size + 2)
        self._n_block, self._n_conv = n_block, n_conv

    def forward(self, img: Tensor) -> dict:
        L = self.levels
        x = img[None, None].to(torch.bfloat16)       # NCHW
        skips = []
        bi = ci = 0
        for _ in range(L):
            x = getattr(self, f"ConvBlock_{bi}")(x); bi += 1
            skips.append(x)
            x = _gelu(getattr(self, f"Conv_{ci}")(x)); ci += 1
        x = getattr(self, f"ConvBlock_{bi}")(x); bi += 1

        if self.pred_head == "conv":
            h = _gelu(getattr(self, f"Conv_{ci}")(x)); ci += 1
            h = _gelu(getattr(self, f"Conv_{ci}")(h)); ci += 1
            h = h.permute(0, 2, 3, 1).reshape(1, -1)   # NHWC flatten
            code_pred = self.code_head_conv(h)[0].to(torch.float32)
        else:
            gap = x.mean(dim=(2, 3))
            code_pred = self.code_head(gap)[0].to(torch.float32)

        prx0s, jacs, stds = [], [], []
        for lvl in reversed(range(L)):
            skip = skips[lvl]
            x = F.interpolate(x, size=skip.shape[-2:], mode="nearest-exact")
            x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"ConvBlock_{bi}")(x); bi += 1
            head = getattr(self, f"Conv_{ci}")(x).to(torch.float32)[0]; ci += 1
            prx0s.append(torch.sigmoid(head[0]))
            stds.append(head[1])
            jacs.append(0.01 * head[2:])
        return {"prx0": tuple(prx0s[::-1]), "jac": tuple(jacs[::-1]),
                "stdev": tuple(stds[::-1]), "code_pred": code_pred}


def params_from_jax(params: dict) -> dict:
    """Map the JAX parameter tree (nested dicts of numpy arrays, as pickled
    by deepfactors_tpu.models.decoder.save_params) to a DepthDecoder
    state_dict: conv kernels [kh, kw, Cin, Cout] -> [Cout, Cin, kh, kw],
    Dense kernels kept [in, out]."""
    tree = params.get("params", params)
    out = {}

    def walk(node, prefix):
        for name, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + name + ".")
                continue
            a = np.asarray(v, np.float32)
            dense = prefix.startswith("code_head")
            if name == "kernel" and not dense:
                out[prefix + "weight"] = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
            else:
                out[prefix + name] = torch.from_numpy(np.array(a))

    walk(tree, "")
    return out


def load_params(path: str) -> dict:
    """Read a pickled JAX parameter tree (numpy arrays only)."""
    with open(path, "rb") as f:
        return pickle.load(f)


class Decoder:
    """The DecoderNetwork facade (decoder_network.h:33-93 equivalent): the
    module on ``device`` with its weights loaded."""

    def __init__(self, cfg: NetworkConfig, params=None, device="cuda",
                 seed: int = 0):
        configure_numerics()
        self.cfg = cfg
        self.device = torch.device(device)
        self.module = DepthDecoder(cfg.code_size, cfg.pyramid_levels,
                                   cfg.base_ch, cfg.pred_head,
                                   (cfg.input_height, cfg.input_width))
        if params is None:
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in self.module.parameters():
                    p.copy_(0.05 * torch.randn(p.shape, generator=g))
        else:
            self.module.load_state_dict(params_from_jax(params))
        self.module.to(self.device).eval()

    @torch.no_grad()
    def raw_outputs_T(self, img: Tensor) -> dict:
        """Feature-major outputs (jac [CS, H_l, W_l]) for the map pools."""
        return self.module(torch.as_tensor(img, device=self.device))

    def raw_outputs(self, img: Tensor) -> dict:
        """The JAX module's output layout: jac [H_l, W_l, CS]."""
        out = self.raw_outputs_T(img)
        out["jac"] = tuple(j.permute(1, 2, 0) for j in out["jac"])
        return out

    def _decode(self, out, code):
        prx = tuple(p + torch.einsum("hwc,c->hw", j, code)
                    for p, j in zip(out["prx0"], out["jac"]))
        return DecodeResult(prx, out["prx0"], out["jac"], out["stdev"], code)

    def decode(self, img: Tensor, code: Tensor) -> DecodeResult:
        """Decode with a given code (decoder_network.cpp:59-137)."""
        return self._decode(self.raw_outputs(img), code)

    def predict_and_decode(self, img: Tensor) -> DecodeResult:
        """Predict the code then decode (decoder_network.cpp:139-229)."""
        out = self.raw_outputs(img)
        return self._decode(out, out["code_pred"])


def load_decoder(prefix: str, device="cuda") -> Decoder:
    """Decoder from ``<prefix>.json`` + ``<prefix>.pkl`` (e.g.
    data/nets/room256_32v4)."""
    import json

    with open(prefix + ".json") as f:
        nj = json.load(f)
    cfg = NetworkConfig(
        code_size=nj["code_size"], pyramid_levels=nj["pyramid_levels"],
        input_width=nj["input_width"], input_height=nj["input_height"],
        avg_dpt=nj["avg_dpt"], base_ch=nj.get("base_ch", 32),
        pred_head=nj.get("pred_head", "gap"))
    return Decoder(cfg, params=load_params(prefix + ".pkl"), device=device)
