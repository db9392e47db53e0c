"""deepfactors_tpu_torch.models.decoder against the JAX Decoder: the
shipped room256_32v4 checkpoint at its full 192x256, carried across by
``params_from_jax``, and a small random-init network with the "gap" head.

Tolerance: bf16. Both networks keep activations and convolution outputs in
bfloat16, but XLA's patch einsum and PyTorch's conv2d round at different
places; over ~15 layers that reaches a few bf16 ulps (2^-8 each) of the
largest activations. Each output is held to 2e-2 of its largest |value|
(prx0, jac, stdev per pyramid level, and the predicted code).

A random-init network's heads are a near-cancelling sum of O(0.1)
activations, so their largest |value| says little of the rounding they
carry: there the denominator has a floor of 0.1 (1e-3 for the 0.01-scaled
code basis)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepfactors_tpu.models import decoder as jdm
from deepfactors_tpu_torch.models import decoder as tdm

torch.set_num_threads(2)
TOL = 2e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = os.path.join(ROOT, "data", "nets", "room256_32v4")


def image(H, W, seed=0):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    rng = np.random.RandomState(seed)
    return (0.5 + 0.3 * np.sin(xs / 9) * np.cos(ys / 7)
            + 0.05 * rng.rand(H, W)).astype(np.float32)


def random_decoder_params(cfg, seed: int) -> dict:
    """A random-init JAX parameter tree for ``cfg`` (a NetworkConfig),
    drawn with numpy from the tree's abstract shapes: kernels N(0, 1/fan_in),
    biases N(0, 0.01^2). flax's own init runs the network op by op, which
    takes ~30 s on the CPU."""
    module = jdm.DepthDecoder(code_size=cfg.code_size, levels=cfg.pyramid_levels,
                              base_ch=cfg.base_ch, pred_head=cfg.pred_head)
    shapes = jax.eval_shape(
        module.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((cfg.input_height, cfg.input_width), jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def compare(out_t, out_j, floor=0.0):
    for key in ("prx0", "jac", "stdev"):
        f = floor * (0.01 if key == "jac" else 1.0)
        assert len(out_t[key]) == len(out_j[key])
        for a, b in zip(out_t[key], out_j[key]):
            a, b = a.float().numpy(), np.asarray(b, np.float32)
            assert a.shape == b.shape, key
            assert np.isfinite(a).all()
            err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), f)
            assert err < TOL, f"{key}: {err}"
    a = out_t["code_pred"].numpy()
    b = np.asarray(out_j["code_pred"])
    assert np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor) < TOL


def test_room256_32v4_matches_jax_at_full_size():
    with open(PREFIX + ".json") as f:
        nj = json.load(f)
    params = tdm.load_params(PREFIX + ".pkl")
    jcfg = jdm.NetworkConfig(
        code_size=nj["code_size"], pyramid_levels=nj["pyramid_levels"],
        input_width=nj["input_width"], input_height=nj["input_height"],
        avg_dpt=nj["avg_dpt"], base_ch=nj["base_ch"], pred_head=nj["pred_head"])
    jdec = jdm.Decoder(jcfg, params=params)
    tdec = tdm.load_decoder(PREFIX, device="cpu")
    assert tdec.cfg.pred_head == "conv" and tdec.cfg.code_size == 32
    img = image(nj["input_height"], nj["input_width"])
    out_j = jdec.raw_outputs(jnp.asarray(img))
    out_t = tdec.raw_outputs(torch.from_numpy(img))
    assert out_t["jac"][0].shape == (192, 256, 32)
    compare(out_t, out_j)


def test_params_from_jax_covers_the_state_dict():
    params = tdm.load_params(PREFIX + ".pkl")
    sd = tdm.params_from_jax(params)
    m = tdm.DepthDecoder(32, 3, 32, "conv", (192, 256))
    assert set(sd) == set(m.state_dict())
    for k, v in m.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_random_small_decoder_matches_jax():
    """The "gap" head (the shipped checkpoint covers "conv")."""
    H, W, CS = 48, 64, 4
    kw = dict(code_size=CS, pyramid_levels=2, input_width=W, input_height=H,
              base_ch=8, pred_head="gap")
    params = random_decoder_params(jdm.NetworkConfig(**kw), seed=3)
    jdec = jdm.Decoder(jdm.NetworkConfig(**kw), params=params)
    tdec = tdm.Decoder(tdm.NetworkConfig(**kw), params=params, device="cpu")
    img = image(H, W, seed=1)
    compare(tdec.raw_outputs(torch.from_numpy(img)),
            jdec.raw_outputs(jnp.asarray(img)), floor=0.1)
    code = np.random.RandomState(2).randn(CS).astype(np.float32)
    rj = jdec.decode(jnp.asarray(img), jnp.asarray(code))
    rt = tdec.decode(torch.from_numpy(img), torch.from_numpy(code))
    for a, b in zip(rt.prx, rj.prx):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) / max(np.max(np.abs(b)), 0.1) < TOL
    pt = tdec.predict_and_decode(torch.from_numpy(img))
    np.testing.assert_array_equal(pt.code.numpy(),
                                  tdec.raw_outputs(torch.from_numpy(img))["code_pred"].numpy())
