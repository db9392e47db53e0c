"""The depth prior of deepfactors_tpu_torch.mapping.mapper
(``MapperConfig.use_depth_prior``, ``Mapper.set_depth_prior``) against the
JAX Mapper, on the scenario of tests/test_mapper.py:174
(``test_depth_prior_pulls_code_to_target_depth``): two 64x96 keyframes of
one image at the identity with a flat synthetic decode (prx = 0.5 +
0.1 code[0], CS 2, so zero photometric signal), both tied to a depth of
2.5 m (sigma 0.05, code prior sigma 100), mapped until the work queue
drains.

What must agree, with the tolerances:
  - the number of mapping steps: identical;
  - the codes: within 1e-4 (the same damped GN on a 2-variable-per-keyframe
    problem in fp32, the sums in another order), and the JAX test's own
    checks (mean depth within 0.05 of 2.5, c0 within 0.1 of its closed
    form) on the port;
  - the decoded level-0 depth: within 1e-4 relative;
  - the prior pyramid: the blur-down pyramid of the target, identical to
    the JAX package's;
  - ``set_depth_prior`` without ``use_depth_prior``: raises in both;
  - ``reset`` (``init_two_frames``) clears the priors in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.mapping.mapper import Mapper as JMapper
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.mapping.mapper import Mapper as TMapper
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.ops import image as tip

torch.set_num_threads(2)
H, W, CS2 = 64, 96, 2
TARGET = 2.5
CODE_TOL = 1e-4
DEPTH_RTOL = 1e-4


def config(MC, **kw):
    base = dict(max_keyframes=2, max_frames=1, max_factors=4, code_size=CS2,
                height=H, width=W, pyramid_levels=2, pho_iters=(6, 6),
                huber_delta=0.3, connection_mode="LASTN",
                max_back_connections=1, lm_lambda=1e-4, use_schur=False,
                use_depth_prior=True, dpt_prior_sigma=0.05, code_prior=100.0)
    base.update(kw)
    return MC(**base)


def _img():
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return (0.5 + 0.2 * np.sin(xs / 5) * np.cos(ys / 4)).astype(np.float32)


def _run_jax():
    cam = JCam.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2, width=W,
                      height=H)
    img = jnp.asarray(_img())
    m = JMapper(config(JMC), cam, decoder=None)
    img_pyr = jip.build_pyramid(img, 2)
    grad_pyr = jip.build_gradient_pyramid(img_pyr)
    prx0 = tuple(jnp.full_like(im, 0.5) for im in img_pyr)
    jac = tuple(jnp.stack([jnp.full_like(im, 0.1), jnp.zeros_like(im)],
                          axis=-1) for im in img_pyr)
    stdev = tuple(jnp.zeros_like(im) for im in img_pyr)
    pyramids = (img_pyr, grad_pyr, prx0, jac, stdev,
                jnp.zeros((CS2,), jnp.float32), None)
    p0 = jse3.identity()
    s0 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    s1 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    m._anchor_pose = p0
    m._add_photo_pair(s0, s1)
    target = np.full((H, W), TARGET, np.float32)
    m.set_depth_prior(s0, target)
    m.set_depth_prior(s1, target)
    pyr = [np.array(p) for p in m.dprior["pyr"]]
    steps = 0
    while m.has_work():
        m.mapping_step()
        steps += 1
    m.update_map()
    return dict(steps=steps, code=np.array(m.state.code),
                dpt=np.array(m.state.levels[0].dpt[:2]), pyr=pyr, m=m)


def _run_torch():
    cam = TCam.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2, width=W,
                      height=H)
    img = torch.from_numpy(_img())
    m = TMapper(config(TMC), cam, device="cpu")
    img_pyr = tuple(tip.build_pyramid(img, 2))
    grad_pyr = tuple(tip.build_gradient_pyramid(img_pyr))
    prx0 = tuple(torch.full_like(im, 0.5) for im in img_pyr)
    # feature-major [CS, h, w], the port's layout
    jac = tuple(torch.stack([torch.full_like(im, 0.1), torch.zeros_like(im)])
                for im in img_pyr)
    stdev = tuple(torch.zeros_like(im) for im in img_pyr)
    pyramids = (img_pyr, grad_pyr, prx0, jac, stdev, torch.zeros(CS2))
    p0 = tse3.identity(device="cpu")
    s0 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    s1 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    m._anchor_pose = p0
    m._add_photo_pair(s0, s1)
    target = np.full((H, W), TARGET, np.float32)
    m.set_depth_prior(s0, target)
    m.set_depth_prior(s1, target)
    pyr = [p.numpy().copy() for p in m.dprior["pyr"]]
    steps = 0
    while m.has_work():
        m.mapping_step()
        steps += 1
    m.update_map()
    return dict(steps=steps, code=m.state.code.numpy().copy(),
                dpt=m.state.levels[0].dpt[:2].numpy().copy(), pyr=pyr, m=m)


@pytest.fixture(scope="module")
def runs():
    return dict(jax=_run_jax(), torch=_run_torch())


def test_depth_prior_pulls_code_like_jax(runs):
    a, b = runs["torch"], runs["jax"]
    assert a["steps"] == b["steps"] > 0
    np.testing.assert_allclose(a["code"], b["code"], rtol=0, atol=CODE_TOL)
    np.testing.assert_allclose(a["dpt"], b["dpt"], rtol=DEPTH_RTOL)
    # the JAX test's own checks, on the port
    assert abs(float(np.mean(a["dpt"][0])) - TARGET) < 0.05
    c0 = float(a["code"][0, 0])
    assert abs(c0 - (2.0 / (2.0 + TARGET) - 0.5) / 0.1) < 0.1, c0


def test_depth_prior_pyramid_identical(runs):
    a, b = runs["torch"]["pyr"], runs["jax"]["pyr"]
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    m = runs["torch"]["m"]
    assert m.dprior["active"].tolist() == [True, True]


def test_set_depth_prior_requires_the_flag():
    cam = TCam.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2, width=W,
                      height=H)
    m = TMapper(config(TMC, use_depth_prior=False), cam, device="cpu")
    with pytest.raises(RuntimeError):
        m.set_depth_prior(0, np.ones((H, W), np.float32))
    jm = JMapper(config(JMC, use_depth_prior=False),
                 JCam.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2, width=W,
                             height=H))
    with pytest.raises(RuntimeError):
        jm.set_depth_prior(0, np.ones((H, W), np.float32))


def test_reset_clears_the_priors(runs):
    for m in (runs["torch"]["m"], runs["jax"]["m"]):
        m.reset()
        assert not np.asarray(m.dprior["active"]).any()
        assert all(np.all(np.asarray(p) == 1.0) for p in m.dprior["pyr"])
