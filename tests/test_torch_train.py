"""Decoder training in the port (deepfactors_tpu_torch/models/train_decoder.py,
deepfactors_tpu_torch/train_room_decoder.py, io/synth.room_dataset,
features/detector.detect_batch) against the JAX package on the CPU, at the
size of tests/test_training.py: code 4, 2 levels, 24x32, base_ch 8 (the
encoder keeps its own 32), a batch of 3.

Parameters: a JAX VAEModel tree drawn with numpy from the tree's abstract
shapes (kernels N(0, 1/fan_in), biases N(0, 0.05^2)) and carried across by
``vae_params_from_jax``; the noise ``eps`` is JAX's own draw, one
``jax.random.normal(k, (CS,))`` per sample with k from ``split(key, B)``,
as JAX's ``make_train_step`` draws it.

Tolerances, each from the spread read over parameter seeds 1-4 and both
code heads (the largest reading in brackets), with its reason:
  - loss and nll relative 2e-4 (3.9e-5): both networks compute in bf16 and
    round at different places (XLA's patch einsum against PyTorch's conv,
    tests/test_torch_decoder.py); kl and distill relative 1e-2 (1.5e-3):
    they are built from mu and logvar, read off a bf16 global mean, so a
    bf16 ulp (2^-8) of an input moves them.
  - kernel gradients per leaf, relative L2 0.2 (0.057), and over all
    kernel leaves together 0.02 (0.0037): the backward runs in bf16 in
    both, and the leaves read worst are the encoder's, whose gradients
    (1e-8) reach it only through the 0.01-scaled code basis.
  - bias gradients against JAX's forward-mode derivative, relative L2 0.15
    (0.042). Not against ``jax.value_and_grad``: on the CPU XLA sums a bf16
    cotangent in bf16 (a sum of 768 x 0.01 gives 4.0), so JAX's reverse-mode
    bias gradients of a bf16 conv saturate there (read 0.57-0.87 off at the
    decoder's first and finest-head convs). PyTorch sums them in fp32, as a
    TPU does; forward mode carries the bias tangent through the layers into
    the fp32 loss and sums nothing in bf16. The encoder's fp32 Dense biases
    agree with JAX's reverse mode too (held to 1e-4).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepfactors_tpu.features import detector as jdet
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.models import decoder as jdm
from deepfactors_tpu.models import train_decoder as jtd
from deepfactors_tpu_torch import train_room_decoder as ttr
from deepfactors_tpu_torch.features import detector as tdet
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.io import synth as tsynth
from deepfactors_tpu_torch.models import decoder as tdm
from deepfactors_tpu_torch.models import train_decoder as ttd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import train_room_decoder as jtr  # noqa: E402  (the JAX tool)

torch.set_num_threads(2)
CS, L, H, W, BC, B = 4, 2, 24, 32, 8, 3
BETA, DISTILL_W = 3e-4, 0.1
LOSS_TOL, TERM_TOL = 2e-4, 1e-2
KERNEL_LEAF_TOL, KERNEL_ALL_TOL, BIAS_TOL = 0.2, 0.02, 0.15
DEC_TOL = 2e-2                      # tests/test_torch_decoder.py's TOL


def _jax_vae(head, seed):
    model = jtd.VAEModel(code_size=CS, levels=L, base_ch=BC, pred_head=head)
    z = jnp.zeros((H, W))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), z, z,
                            jax.random.PRNGKey(0), BETA)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed=0):
    cfg = jdm.NetworkConfig(code_size=CS, pyramid_levels=L, input_width=W,
                            input_height=H)
    imgs, dpts = next(jtd.synthetic_depth_dataset(cfg, batch=B, seed=seed))
    return imgs, (2.0 / (2.0 + dpts)).astype(np.float32)


def _jax_loss_fn(model):
    """JAX make_train_step's loss_fn, as it is there."""
    def loss_fn(params, imgs, gts, rng):
        keys = jax.random.split(rng, imgs.shape[0])
        losses, auxs = jax.vmap(
            lambda i, g, k: model.apply(params, i, g, k, BETA, DISTILL_W))(
                imgs, gts, keys)
        return jnp.mean(losses), jax.tree.map(jnp.mean, auxs)
    return loss_fn


def _jax_eps(key):
    return np.stack([np.asarray(jax.random.normal(k, (CS,)))
                     for k in jax.random.split(key, B)])


_CASES = {}


def _case(head, seed=1):
    """JAX's loss, aux and gradients and the port's, for one head."""
    if (head, seed) in _CASES:
        return _CASES[head, seed]
    model, params = _jax_vae(head, seed)
    imgs, gts = _batch()
    key = jax.random.PRNGKey(5)
    loss_fn = _jax_loss_fn(model)
    (lj, auxj), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(imgs), jnp.asarray(gts), key)
    m = ttd.VAEModel(CS, L, BC, head, (H, W))
    m.load_state_dict(ttd.vae_params_from_jax(params))
    lt, auxt = ttd.vae_loss(m, torch.from_numpy(imgs), torch.from_numpy(gts),
                            BETA, DISTILL_W,
                            eps=torch.from_numpy(_jax_eps(key)))
    lt.backward()
    _CASES[head, seed] = dict(
        model=model, params=params, imgs=imgs, gts=gts, key=key, m=m,
        lj=float(lj), auxj={k: float(v) for k, v in auxj.items()},
        lt=float(lt.detach()), auxt={k: float(v.detach()) for k, v in auxt.items()},
        gj=ttd.vae_params_from_jax(jax.tree.map(np.asarray, gj)))
    return _CASES[head, seed]


@pytest.mark.parametrize("head", ["gap", "conv"])
def test_loss_and_aux_match_jax(head):
    c = _case(head)
    assert abs(c["lt"] - c["lj"]) <= LOSS_TOL * abs(c["lj"])
    assert abs(c["auxt"]["nll"] - c["auxj"]["nll"]) <= LOSS_TOL * abs(
        c["auxj"]["nll"])
    for k in ("kl", "distill"):
        assert abs(c["auxt"][k] - c["auxj"][k]) <= TERM_TOL * abs(
            c["auxj"][k]), k


@pytest.mark.parametrize("head", ["gap", "conv"])
def test_kernel_gradients_match_jax(head):
    c = _case(head)
    num = den = 0.0
    names = [n for n, _ in c["m"].named_parameters() if not n.endswith("bias")]
    assert len(names) == len([k for k in c["gj"] if not k.endswith("bias")])
    for n in names:
        a = dict(c["m"].named_parameters())[n].grad.numpy()
        b = c["gj"][n].numpy()
        assert a.shape == b.shape and np.isfinite(a).all(), n
        err = np.linalg.norm(a - b)
        assert err <= KERNEL_LEAF_TOL * np.linalg.norm(b), (n, err)
        num, den = num + err ** 2, den + np.linalg.norm(b) ** 2
    assert np.sqrt(num / den) <= KERNEL_ALL_TOL


def test_bias_gradients_match_jax_forward_mode():
    """The decoder's first and finest-head conv biases and the encoder's
    first conv and two Dense biases, against jax.jacfwd of JAX's loss."""
    c = _case("gap")
    picks = ["decoder.ConvBlock_0.Conv_0.bias", "decoder.Conv_3.bias",
             "encoder.ConvBlock_0.Conv_0.bias", "encoder.Dense_0.bias",
             "encoder.Dense_1.bias"]
    flat, tdef = jax.tree_util.tree_flatten_with_path(c["params"])
    names = [".".join(k.key for k in p[1:]) for p, _ in flat]
    leaves = [v for _, v in flat]
    at = [names.index(n) for n in picks]
    loss_fn = _jax_loss_fn(c["model"])
    imgs, gts = jnp.asarray(c["imgs"]), jnp.asarray(c["gts"])

    def loss_of(vec):
        ls, o = list(leaves), 0
        for i in at:
            ls[i] = vec[o:o + leaves[i].size].reshape(leaves[i].shape)
            o += leaves[i].size
        return loss_fn(jax.tree_util.tree_unflatten(tdef, ls), imgs, gts,
                       c["key"])[0]

    x0 = jnp.concatenate([leaves[i].reshape(-1) for i in at])
    fwd = np.asarray(jax.jit(jax.jacfwd(loss_of))(x0))
    o = 0
    for n, i in zip(picks, at):
        want = fwd[o:o + leaves[i].size]
        o += leaves[i].size
        got = dict(c["m"].named_parameters())[n].grad.numpy().reshape(-1)
        assert np.linalg.norm(got - want) <= BIAS_TOL * np.linalg.norm(want), n
        if "Dense" in n:
            rev = c["gj"][n].numpy().reshape(-1)
            assert np.linalg.norm(rev - want) <= 1e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("kind", ["adam", "adamw_cosine"])
@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_optimizer_matches_optax(kind, scale):
    """Three updates of clip_by_global_norm(1.0) + adam / adamw(cosine
    schedule) on random parameters and gradients, below and above the clip
    (scale 0.05: norm ~0.3; 3.0: ~15). The port applies the same
    operations in the same order; XLA fuses some of them (multiply-adds),
    so a parameter may differ by an ulp or two of itself: limit 2^-21 of
    max(1, |p|) (read: 2.4e-7 at |p| ~ 2-4)."""
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    P = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in P.items()}
    if kind == "adam":
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
        opt = ttd.OptaxAdam(list(tp.values()), 1e-2, clip_norm=1.0)
    else:
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.cosine_decay_schedule(1e-2, 5, alpha=0.1)))
        opt = ttd.OptaxAdam(list(tp.values()),
                            ttd.cosine_decay_schedule(1e-2, 5, 0.1),
                            weight_decay=1e-4, clip_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    state = tx.init(jp)
    for _ in range(3):
        G = {k: (scale * rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
        up, state = tx.update({k: jnp.asarray(v) for k, v in G.items()},
                              state, jp)
        jp = optax.apply_updates(jp, up)
        for k in tp:
            tp[k].grad = torch.from_numpy(G[k])
        gnorm = float(opt.step())
        want_norm = float(optax.global_norm(G))
        assert abs(gnorm - want_norm) <= 1e-6 * want_norm
        for k in P:
            a, b = tp[k].detach().numpy(), np.asarray(jp[k])
            assert (np.abs(a - b) <= 2.0 ** -21
                    * np.maximum(1.0, np.abs(b))).all(), k


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(3e-4, 36000, alpha=0.1)
    ours = ttd.cosine_decay_schedule(3e-4, 36000, 0.1)
    for n in (0, 1, 299, 17999, 36000, 40000):
        want = float(sched(jnp.asarray(n, jnp.int32)))
        assert abs(ours(n) - want) <= 2.0 ** -23 * want, n


@pytest.mark.parametrize("hw", [(24, 32), (192, 256)])
def test_gt_pyramid_matches_jax_resize(hw):
    """jax.image.resize(method="linear") antialiases when it downsamples;
    F.interpolate(antialias=True) computes the same triangle weights,
    renormalised at the border: 2x and 4x within 2.4e-7 (an fp32 ulp of the
    largest value, read 1.2e-7), the same size unchanged."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, *hw).astype(np.float32)
    for f in (1, 2, 4):
        size = (hw[0] // f, hw[1] // f)
        want = np.asarray(jax.vmap(lambda a: jax.image.resize(
            a, size, method="linear"))(jnp.asarray(x)))
        got = ttd.resize_linear(torch.from_numpy(x), size).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def test_synthetic_depth_dataset_equals_jax():
    cfg = jdm.NetworkConfig(code_size=CS, pyramid_levels=L, input_width=W,
                            input_height=H)
    a = ttd.synthetic_depth_dataset(cfg, batch=3, seed=4)
    b = jtd.synthetic_depth_dataset(cfg, batch=3, seed=4)
    for _ in range(3):
        (ai, ad), (bi, bd) = next(a), next(b)
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(ad, bd)


def _cams(h, w, f):
    kw = dict(fx=f, fy=f, u0=w / 2, v0=h / 2, width=w, height=h)
    return JCam.create(**kw), TCam.create(**kw)


def test_room_dataset_first_batch_matches_jax():
    """The same draws (room, then pose) and render_aa within 1e-5."""
    jc, tc = _cams(H, W, 27.5)
    a = next(tsynth.room_dataset(H, W, tc, batch=3, seed=2, rooms=4,
                                 device="cpu"))
    b = next(jsynth.room_dataset(H, W, jc, batch=3, seed=2, rooms=4))
    for x, y in zip(a, b):
        assert x.shape == y.shape == (3, H, W)
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("randomize", [False, True])
def test_build_dataset_matches_jax_tool(randomize):
    """tools/train_room_decoder.build_dataset's draws and renders: images
    within 1e-5 (read 2.9e-6), depths within 1e-6 of the largest (2.0e-7)."""
    jc, tc = _cams(H, W, 30.0)
    ji, jd = jtr.build_dataset(2, 10, H, W, jc, seed=3, randomize=randomize)
    ti, td = ttr.build_dataset(2, 10, H, W, tc, seed=3, randomize=randomize,
                               device="cpu")
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-5)
    jd = np.asarray(jd)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0,
                               atol=1e-6 * np.abs(jd).max())


@pytest.mark.parametrize("strength", ["mild", "strong"])
def test_augment_matches_jax_tool_at_its_draws(strength):
    """make_augment's photometric randomisation with JAX's own draws (its
    seven uniforms, noise field and blur coin per sample): within 1e-6
    (read 1.8e-7; pow and the blur's sums round differently)."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(4, H, W).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.asarray(jtr.make_augment(H, W, strength)(jnp.asarray(imgs),
                                                       keys))
    A = ttr.AUG[strength]
    ranges = [A["gamma"], A["gain"], (-A["bias"], A["bias"]),
              (-A["ramp"], A["ramp"]), (-A["ramp"], A["ramp"]),
              (0.0, A["vig"]), (0.0, A["noise"])]
    vals, noise, blur = [], [], []
    for k in keys:
        ks = jax.random.split(k, 8)
        vals.append([float(jax.random.uniform(ks[i], (), minval=lo,
                                              maxval=hi))
                     for i, (lo, hi) in enumerate(ranges)])
        noise.append(np.asarray(jax.random.normal(ks[6], (H, W))))
        blur.append(bool(jax.random.bernoulli(ks[7], A["blur_p"])))
    got = ttr.apply_augment(torch.from_numpy(imgs), torch.tensor(vals),
                            torch.from_numpy(np.stack(noise)),
                            torch.tensor(blur)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the generator-driven augment stays in range and is reproducible
    g = lambda: torch.Generator().manual_seed(9)
    aug = ttr.make_augment(strength)
    x = aug(torch.from_numpy(imgs), g())
    assert torch.equal(x, aug(torch.from_numpy(imgs), g()))
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


def test_detect_batch_matches_jax():
    """Each image of the batch as tests/test_torch_features.py holds
    ``detect``: valid flags and positions identical, angles within 1e-4,
    descriptors within a bit a keypoint and two over the image."""
    jc, _ = _cams(48, 64, 55.0)
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)[:7]
    frames = np.stack(jsynth.render_sequence(scene, jc, poses, 48, 64))[4:7]
    cfg = dict(max_keypoints=128, border=8)
    a = tdet.detect_batch(torch.from_numpy(frames), tdet.DetectorConfig(**cfg))
    b = jdet.detect_batch(jnp.asarray(frames), jdet.DetectorConfig(**cfg))
    assert a.xy.shape == (3, 128, 2) and a.descriptor.shape[:2] == (3, 128)
    for i in range(3):
        va, vb = a.valid[i].numpy(), np.asarray(b.valid[i])
        np.testing.assert_array_equal(va, vb)
        assert vb.sum() >= 5
        np.testing.assert_array_equal(a.xy[i].numpy()[vb],
                                      np.asarray(b.xy[i])[vb])
        np.testing.assert_allclose(a.angle[i].numpy()[vb],
                                   np.asarray(b.angle[i])[vb], atol=1e-4)
        x = np.bitwise_xor(a.descriptor[i].numpy().view(np.uint32)[vb],
                           np.asarray(b.descriptor[i])[vb])
        bits = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
        assert bits.max(initial=0) <= 1 and bits.sum() <= 2


def test_save_params_round_trip_both_packages(tmp_path):
    """Weights trained in the port, written by ``save_params``, load in the
    JAX package's Decoder and decode as the port's within the decoder
    test's bf16 limit; reading them back gives the same tensors."""
    m = ttd.VAEModel(CS, L, BC, "conv", (H, W))
    tdm.init_flax_defaults(m, torch.Generator().manual_seed(3))
    path = str(tmp_path / "net.pkl")
    tdm.save_params(path, ttd.extract_decoder_params(m))
    params = tdm.load_params(path)
    back = tdm.params_from_jax(params)
    for k, v in m.decoder.state_dict().items():
        assert torch.equal(back[k], v), k
    cfg_kw = dict(code_size=CS, pyramid_levels=L, input_width=W,
                  input_height=H, base_ch=BC, pred_head="conv")
    jdec = jdm.Decoder(jdm.NetworkConfig(**cfg_kw), params=jdm.load_params(path))
    tdec = tdm.Decoder(tdm.NetworkConfig(**cfg_kw), params=params,
                       device="cpu")
    img = _batch()[0][0]
    code = np.random.RandomState(2).randn(CS).astype(np.float32)
    rj = jdec.decode(jnp.asarray(img), jnp.asarray(code))
    rt = tdec.decode(torch.from_numpy(img), torch.from_numpy(code))
    for a, b in zip(rt.prx, rj.prx):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= DEC_TOL * np.max(np.abs(b))
    # the whole VAE tree carries both ways
    tree = ttd.vae_params_to_jax(m)
    sd = ttd.vae_params_from_jax(tree)
    assert all(torch.equal(sd[k], v) for k, v in m.state_dict().items())


def test_flax_default_init():
    """init_flax_defaults: the leaves of flax's tree for the same model (by
    jax.eval_shape), zero biases, and kernels of lecun_normal's spread (std
    1/sqrt(fan_in), never beyond 2 / 0.8796 of it)."""
    m = ttd.VAEModel(CS, L, BC, "conv", (H, W))
    tdm.init_flax_defaults(m, torch.Generator().manual_seed(0))
    _, ref = _jax_vae("conv", 0)
    sd_ref = ttd.vae_params_from_jax(ref)
    assert set(sd_ref) == set(m.state_dict())
    for n, p in m.state_dict().items():
        assert p.shape == sd_ref[n].shape, n
        if n.endswith("bias"):
            assert not p.any(), n
            continue
        fan_in = p[0].numel() if p.dim() == 4 else p.shape[0]
        std = 1.0 / np.sqrt(fan_in)
        assert float(p.abs().max()) <= 2.0 / 0.87962566103423978 * std + 1e-7
        if p.numel() >= 500:
            assert abs(float(p.std()) / std - 1.0) < 0.15, n


def test_batched_forward_matches_unbatched():
    """DepthDecoder.forward on [1, H, W] equals [H, W] bit for bit, and each
    sample of a batch of 3 its own forward within the bf16 limit."""
    m = tdm.DepthDecoder(CS, L, BC, "conv", (H, W))
    tdm.init_flax_defaults(m, torch.Generator().manual_seed(1))
    imgs = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        one = m(imgs[0])
        b1 = m(imgs[:1])
        b3 = m(imgs)
    for k in ("prx0", "jac", "stdev"):
        for a, b in zip(one[k], b1[k]):
            assert torch.equal(a, b[0]), k
    assert torch.equal(one["code_pred"], b1["code_pred"][0])
    for i in range(3):
        with torch.no_grad():
            s = m(imgs[i])
        for a, b in zip(s["prx0"], b3["prx0"]):
            assert float((a - b[i]).abs().max()) <= DEC_TOL * float(a.abs().max())


def test_training_reduces_loss_and_stays_linear():
    """tests/test_training.py's checks, in the port: 40 steps of clip +
    adam(3e-4) on the synthetic dataset (batch 2) from flax's default init;
    the mean nll of the last 5 steps below that of the first 5, and the
    decoder built from the trained weights linear in the code."""
    cfg = tdm.NetworkConfig(code_size=CS, pyramid_levels=L, input_width=W,
                            input_height=H)
    data = ttd.synthetic_depth_dataset(cfg, batch=2)
    m = ttd.VAEModel(CS, L, input_hw=(H, W))
    tdm.init_flax_defaults(m, torch.Generator().manual_seed(0))
    opt = ttd.OptaxAdam(m.parameters(), 3e-4, clip_norm=1.0)
    step = ttd.make_train_step(m, opt)
    gen = torch.Generator().manual_seed(0)
    nlls = []
    for _ in range(40):
        imgs, dpts = next(data)
        loss, aux = step(torch.from_numpy(imgs),
                         torch.from_numpy(2.0 / (2.0 + dpts)), generator=gen)
        nlls.append(float(aux["nll"]))
    assert np.mean(nlls[-5:]) < np.mean(nlls[:5]), nlls
    dec = tdm.Decoder(cfg, params=ttd.extract_decoder_params(m), device="cpu")
    img = torch.zeros(H, W)
    res = dec.decode(img, torch.zeros(CS))
    assert res.prx[0].shape == (H, W)
    c = torch.full((CS,), 0.3)
    res_c = dec.decode(img, c)
    pred = res.prx[0] + res.jac[0] @ c
    np.testing.assert_allclose(res_c.prx[0].numpy(), pred.numpy(), atol=1e-5)


def test_train_function_on_the_cpu():
    """``train`` (JAX's ``train``: VAEModel(code_size, levels), clip +
    adam) from a synthetic iterator: the loss every ``log_every`` steps and
    the decoder's parameters in the JAX layout, which the JAX Decoder
    loads."""
    cfg = tdm.NetworkConfig(code_size=CS, pyramid_levels=L, input_width=W,
                            input_height=H)
    params, history = ttd.train(cfg, ttd.synthetic_depth_dataset(cfg, 2), 4,
                                lr=1e-3, log_every=2, device="cpu",
                                log=lambda *a: None)
    assert len(history) == 2 and np.isfinite(history).all()
    jdec = jdm.Decoder(jdm.NetworkConfig(code_size=CS, pyramid_levels=L,
                                         input_width=W, input_height=H),
                       params=params)
    out = jdec.raw_outputs(jnp.zeros((H, W)))
    assert out["jac"][0].shape == (H, W, CS)


def test_train_entry_on_the_cpu(tmp_path):
    """``python -m deepfactors_tpu_torch.train_room_decoder --device cpu``,
    two steps on two views: the files and the JSON keys of the JAX tool;
    both packages load the weights written; the card is the default."""
    out = str(tmp_path / "nets" / "t")
    argv = ["--steps", "2", "--batch", "2", "--rooms", "1", "--val-rooms",
            "1", "--poses-per-room", "2", "--randomize", "--pred-head",
            "conv", "--out", out, "--log-every", "1", "--device", "cpu"]
    r = ttr.main(argv, log=lambda *a: None)
    assert r["nll"].shape == (2,) and np.isfinite(r["nll"]).all()
    assert len(r["step_ms"]) == 2 and r["frames"] == 2
    assert np.isfinite(r["val"]).all() and r["val"].shape == (7,)
    with open(out + ".json") as f:
        meta = json.load(f)
    assert set(meta) == {
        "code_size", "pyramid_levels", "input_width", "input_height",
        "avg_dpt", "grayscale", "fx", "fy", "u0", "v0", "base_ch",
        "pred_head", "trained_on", "val_depth_rmse_zero_code",
        "val_depth_rmse_pred_code", "val_depth_rmse_opt_code",
        "val_prox_rmse_zero_code", "val_prox_rmse_pred_code"}
    assert meta["pred_head"] == "conv" and meta["code_size"] == 32
    dec = tdm.load_decoder(out, device="cpu")
    assert dec.cfg.pred_head == "conv"
    jparams = jdm.load_params(out + ".pkl")
    jdm.Decoder(jdm.NetworkConfig(code_size=32, pyramid_levels=3,
                                  base_ch=32, pred_head="conv"),
                params=jparams)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            ttr.main(argv[:-2], log=lambda *a: None)
