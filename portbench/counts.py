"""The yardstick's arithmetic: the card's peaks and the operations and bytes
each measured piece of work needs, counted from its shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W
power limit). A roofline share is the least time the card could take, the
larger of operations over the peak rate and bytes over the memory rate,
over the time the work took.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12     # HBM3, bytes a second

# dense_warp, per pixel of a factor: the pixel's ray (4), its scaled point
# (2), the transform (18), the projection (6), the bilinear weights (2)
# and three planes sampled (9 each); comparisons and floors not counted
DENSE_WARP_FLOPS_PER_PIXEL = 59
# dense_warp reads depth, image and two gradient planes and writes seven
# planes (i1, gx, gy, tptx, tpty, tptz, valid), fp32
DENSE_WARP_PLANES = 11
# the training encoder's base width, whatever the decoder's
ENCODER_CH = 32


def dense_warp_bytes(factors: int, H: int, W: int) -> int:
    return DENSE_WARP_PLANES * 4 * H * W * factors


def dense_warp_flops(factors: int, H: int, W: int) -> int:
    return DENSE_WARP_FLOPS_PER_PIXEL * H * W * factors


def roofline_bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take for the work."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def schur_flops(K: int, CS: int) -> int:
    """A Schur solve of K poses (6 each) and K codes (CS each), the codes
    eliminated: the K code blocks' Cholesky (CS^3 / 3 each), their solves
    against [A_cx | b_c] (two triangular solves of 6K + 1 columns), the
    Schur complement S = A_xx - A_xc C^-1 A_cx and its right-hand side,
    S's Cholesky and solve, and the codes' back-substitution."""
    Dx, Dc = 6 * K, CS * K
    return (K * CS ** 3 // 3 + 2 * K * CS * CS * (Dx + 1)
            + 2 * Dx * Dc * Dx + 2 * Dx * Dc + Dx ** 3 // 3 + 2 * Dx * Dx
            + 2 * Dc * Dx)


def ba_iteration_flops(factors: int, K: int, CS: int, H: int, W: int) -> int:
    """The fp32 operations a BA iteration needs: per factor and pixel the
    outer product of the (12 + CS)-wide Jacobian row and its product with
    the residual (2 D^2 + 2 D), then the Schur solve at D = K (6 + CS)."""
    D = 12 + CS
    return factors * H * W * (2 * D * D + 2 * D) + schur_flops(K, CS)


def _conv_out(n: int, stride: int) -> int:
    return -(-n // stride)


def train_conv_flops(batch: int, code_size: int = 32, levels: int = 3,
                     base_ch: int = 32, H: int = 192, W: int = 256) -> int:
    """The convolutions' operations of one training step of the depth
    network with its convolutional code head and the training encoder:
    2 k^2 Cin Cout Ho Wo a convolution and an image forward, times 3 for
    the forward, the data gradient and the weight gradient (the count
    ``port_tools/profile_e2e.py --phase train`` makes with forward hooks:
    642.1 GFLOP at batch 8)."""
    convs = []                       # (cin, cout, stride, h_in, w_in)

    def conv(cin, cout, s, h, w):
        convs.append((cin, cout, s, h, w))
        return _conv_out(h, s), _conv_out(w, s)

    def block(cin, ch, h, w):
        conv(cin, ch, 1, h, w)
        conv(ch, ch, 1, h, w)

    h, w = H, W
    ch, cin, skips = base_ch, 1, []
    for _ in range(levels):
        block(cin, ch, h, w)
        skips.append((ch, h, w))
        h, w = conv(ch, 2 * ch, 2, h, w)
        cin, ch = 2 * ch, min(2 * ch, 8 * base_ch)
    block(cin, ch, h, w)
    hh, ww = conv(ch, ch, 2, h, w)
    conv(ch, 64, 2, hh, ww)
    x_ch = ch
    for lvl in reversed(range(levels)):
        sc, sh, sw = skips[lvl]
        block(x_ch + sc, sc, sh, sw)
        x_ch = sc
        conv(x_ch, code_size + 2, 1, sh, sw)
    h, w = H, W
    ch, cin = ENCODER_CH, 2
    for _ in range(4):
        nxt = min(2 * ch, 4 * ENCODER_CH)
        block(cin, ch, h, w)
        h, w = conv(ch, nxt, 2, h, w)
        cin = ch = nxt
    fwd = sum(2 * 9 * ci * co * _conv_out(hi, s) * _conv_out(wi, s)
              for ci, co, s, hi, wi in convs)
    return 3 * fwd * batch
