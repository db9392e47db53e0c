"""The yardstick's operation and byte counts against counts made by hand,
and the training count against forward hooks on the port's model."""
import pytest
import torch

from portbench import counts


def test_dense_warp_counts_by_hand():
    # 2 factors of 3x4 pixels: 11 fp32 planes, 59 operations a pixel
    assert counts.dense_warp_bytes(2, 3, 4) == 2 * 12 * 11 * 4
    assert counts.dense_warp_flops(2, 3, 4) == 2 * 12 * 59


def test_schur_flops_by_hand():
    # K = 1, CS = 2: Dx = 6, Dc = 2
    cholesky_c = 1 * 8 // 3                  # CS^3 / 3
    solves_c = 2 * 1 * 4 * 7                 # two triangular solves, 7 cols
    schur = 2 * 6 * 2 * 6                    # A_xc C^-1 A_cx
    rhs = 2 * 6 * 2
    cholesky_s = 6 ** 3 // 3
    solve_s = 2 * 36
    back = 2 * 2 * 6
    assert counts.schur_flops(1, 2) == (cholesky_c + solves_c + schur + rhs
                                        + cholesky_s + solve_s + back)


def test_ba_iteration_flops_by_hand():
    # 3 factors of 2x2 pixels at CS = 2: rows of 14, 2 * 14^2 + 2 * 14
    assert counts.ba_iteration_flops(3, 1, 2, 2, 2) == \
        3 * 4 * (2 * 196 + 28) + counts.schur_flops(1, 2)


def test_roofline_bound():
    assert counts.roofline_bound_s(67e12, 0, counts.PEAK_FP32_FLOPS) == 1.0
    assert counts.roofline_bound_s(0, 3.35e12, counts.PEAK_FP32_FLOPS) == 1.0


def test_train_count_at_the_recipe_batch():
    # port_tools/profile_e2e.py --phase train: 642.1 GFLOP at batch 8
    assert counts.train_conv_flops(8) == 642105999360


@pytest.mark.parametrize("hw,base,cs", [((48, 64), 8, 8), ((40, 56), 4, 6)])
def test_train_count_against_forward_hooks(hw, base, cs):
    """Every convolution of the port's model, counted as it runs."""
    from deepfactors_tpu_torch.models import decoder as dm
    from deepfactors_tpu_torch.models import train_decoder as td

    torch.manual_seed(0)
    model = td.VAEModel(cs, 3, base, "conv", hw)
    fwd = [0]

    def hook(mod, inp, out):
        fwd[0] += 2 * mod.k * mod.k * mod.weight.shape[1] * out.numel()

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, dm.Conv)]
    B = 2
    imgs = torch.rand((B,) + hw)
    with torch.no_grad():
        td.vae_loss(model, imgs, torch.rand((B,) + hw), 1e-3,
                    eps=torch.zeros(B, cs))
    for h in hooks:
        h.remove()
    assert counts.train_conv_flops(B, cs, 3, base, *hw) == 3 * fwd[0]
