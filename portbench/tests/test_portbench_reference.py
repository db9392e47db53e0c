"""Each plain reference against the port at a tiny size on the CPU: the
network's forward pass, one bundle-adjustment step and a solve of the large
map, and the first training steps."""
import numpy as np
import pytest
import torch

from portbench import synth
from .tiny import tiny_problem
from portbench.reference import largemap as rlm
from portbench.reference import net
from portbench.reference import train as rtr

torch.set_num_threads(2)


def _params(seed=0, cs=8, base=8, hw=(48, 64)):
    p = net.init_params(net.param_shapes(cs, 3, base, hw), seed,
                        torch.device("cpu"))
    g = torch.Generator().manual_seed(seed + 7)
    # non-zero biases, so that the bias path is compared too
    return {k: (v + 0.05 * torch.randn(v.shape, generator=g)
                if k.endswith("bias") else v) for k, v in p.items()}


def test_network_forward_matches_the_port():
    from deepfactors_tpu_torch.models import train_decoder as td

    p = _params()
    model = td.VAEModel(8, 3, 8, "conv", (48, 64))
    model.load_state_dict(p)
    g = torch.Generator().manual_seed(3)
    img = torch.rand((2, 48, 64), generator=g)
    prox = torch.rand((2, 48, 64), generator=g)
    with torch.no_grad():
        want = model.decoder(img)
        got = net.decoder_forward(p, img, 3)
        for k in ("prx0", "jac", "stdev"):
            for a, b in zip(got[k], want[k]):
                assert torch.equal(a, b), k
        assert torch.equal(got["code_pred"], want["code_pred"])
        for a, b in zip(net.encoder_forward(p, img, prox),
                        model.encoder(img, prox)):
            assert torch.equal(a, b)
        low = net.decoder_forward(p, img, 3, quantise="fp8")
        assert not torch.equal(low["prx0"][0], want["prx0"][0])


@pytest.fixture(scope="module")
def problem():
    return tiny_problem(K=5, seed=4)


def test_one_ba_step_matches_the_port(problem):
    """Every factor's normal equations agree to fp32's rounding; the step
    agrees as far as the program's fp32 solve of this small, poorly
    conditioned system allows (the reference solves in fp64)."""
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.parallel import dist_ba

    pr, inp, cam, pcam, sfm, priors = problem
    K, CS = pr.codes.shape
    codes = 0.1 * torch.randn((K, CS), generator=torch.Generator()
                              .manual_seed(1))
    s, d = inp.src, inp.dst
    prx = pr.fd.prx0 + torch.einsum("phwc,pc->phw", pr.fd.jac0, codes[s])
    sys = ds.sfm_step_batch(
        SE3(pr.pose_q[s], pr.pose_t[s]), SE3(pr.pose_q[d], pr.pose_t[d]),
        codes[s], pcam, pr.fd.img0, pr.fd.img1,
        sfm["avg_dpt"] / prx - sfm["avg_dpt"], pr.fd.std0, pr.fd.jac0,
        pr.fd.grad1, sfm_params(sfm))
    JtJ, Jtr, _ = rlm.linearise(inp, pr.pose_q, pr.pose_t, codes, cam, sfm,
                             slice(0, s.shape[0]))
    for blk in (slice(0, 6), slice(6, 12), slice(12, None)):
        for a, b in ((sys.JtJ[:, blk], JtJ[:, blk]),
                     (sys.Jtr[:, blk], Jtr[:, blk])):
            assert float((a - b).abs().max()) < 1e-5 * float(b.abs().max())
    step = dist_ba.make_ba_step(K, CS, pcam, sfm_params(sfm), **priors)
    q, t, c, _ = step(pr.pose_q, pr.pose_t, codes, pr.fd, pr.active)
    qr, tr, cr = rlm.gn_step(inp, pr.pose_q, pr.pose_t, codes, cam, sfm,
                             priors)
    g = rlm.gaps(q, t, c, qr, tr, cr)
    moved = float((tr - pr.pose_t).norm(dim=-1).max())
    turned = float(rlm.rotation_gap(qr, pr.pose_q).max())
    assert g["t_gap_m"] < 0.02 * moved and g["r_gap_rad"] < 0.02 * turned, g
    assert g["code_gap"] < 1e-4, g


def test_a_solve_matches_the_port(problem):
    from deepfactors_tpu_torch.parallel import large_map

    pr, inp, cam, pcam, sfm, priors = problem
    K, CS = pr.codes.shape
    ba = large_map.LargeMapBA(K, CS, pcam, sfm_params(sfm), **priors)
    est, c, _ = ba.run(pr, iters=4)
    q, t, cr = rlm.solve(inp, pr.pose_q, pr.pose_t, cam, sfm, priors, 4)
    g = rlm.gaps(est.q, est.t, c, q, t, cr)
    moved = float((t - pr.pose_t).norm(dim=-1).max())
    assert g["t_gap_m"] < 0.02 * moved and g["r_gap_rad"] < 2e-3, g


def sfm_params(sfm):
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    return ds.SfmParams(**sfm)


def test_rotation_helpers():
    g = torch.Generator().manual_seed(2)
    w = 0.3 * torch.randn((6, 3), generator=g, dtype=torch.float64)
    q = rlm.exp_quat(w)
    assert torch.allclose(rlm.log_quat(q), w, atol=1e-12)
    R = rlm.quat_matrix(q)
    assert torch.allclose(R @ R.transpose(-1, -2),
                          torch.eye(3, dtype=torch.float64).expand(6, 3, 3),
                          atol=1e-12)
    assert torch.allclose(rlm.rotation_gap(q, q), torch.zeros(6,
                                                             dtype=q.dtype))
    two = rlm.rotation_gap(rlm.exp_quat(torch.zeros_like(w)), q)
    assert torch.allclose(two, w.norm(dim=-1), atol=1e-12)
    assert torch.allclose(synth.quat_to_matrix(q.float()), R.float(),
                          atol=1e-6)


def test_training_steps_match_the_port():
    from deepfactors_tpu_torch.models import train_decoder as td

    p = _params(seed=3)
    hp = dict(lr=3e-4, decay_steps=100, alpha=0.1, weight_decay=1e-4,
              clip=1.0, beta=3e-4, distill_w=0.1)
    model = td.VAEModel(8, 3, 8, "conv", (48, 64))
    model.load_state_dict(p)
    opt = td.OptaxAdam(model.parameters(),
                       td.cosine_decay_schedule(hp["lr"], hp["decay_steps"],
                                                hp["alpha"]),
                       weight_decay=hp["weight_decay"], clip_norm=hp["clip"])
    step = td.make_train_step(model, opt, hp["beta"], hp["distill_w"])
    g = torch.Generator().manual_seed(9)
    batches = [(torch.rand((4, 48, 64), generator=g),
                0.3 + 0.5 * torch.rand((4, 48, 64), generator=g),
                torch.randn((4, 8), generator=g)) for _ in range(3)]
    losses = [float(step(*b[:2], eps=b[2])[0]) for b in batches]
    ref = rtr.follow(p, batches, hp, 3)
    assert np.allclose(losses, ref["loss"], rtol=1e-5)
    change = {n: float((q.detach() - p[n]).norm())
              for n, q in model.named_parameters()}
    assert rtr.worst_leaf_gap(change, ref["change"]) < 1e-3
    low = rtr.follow(p, batches, hp, 3, quantise="fp8")
    assert abs(low["loss"][0] - ref["loss"][0]) > 0.0
