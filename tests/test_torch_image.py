"""deepfactors_tpu_torch.ops.image against the JAX package on identical
seeded images: pyramids, Sobel gradients, bilinear sampling (value and the
interpolant's gradient, including the edge convention of zeroed weights at
the last row/column) and update_depth. Tolerance 1e-6 absolute (values in
[0, 1]; the filters use the same taps in the same order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.ops import image as jip
from deepfactors_tpu_torch.ops import image as tip

torch.set_num_threads(2)
TOL = 1e-6


def close(a, b, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)


@pytest.mark.parametrize("H,W", [(48, 64), (37, 50)])
def test_pyramid_and_gradients(H, W):
    img = np.random.RandomState(0).rand(H, W).astype(np.float32)
    pj = jip.build_pyramid(jnp.asarray(img), 3)
    pt = tip.build_pyramid(torch.from_numpy(img), 3)
    for a, b in zip(pt, pj):
        close(a, b)
    for a, b in zip(tip.build_gradient_pyramid(pt), jip.build_gradient_pyramid(pj)):
        close(a, b)


def test_batched_pyramid_matches_per_image():
    imgs = np.random.RandomState(1).rand(3, 32, 48).astype(np.float32)
    down = tip.gaussian_blur_down(torch.from_numpy(imgs))
    grads = tip.sobel_gradients(torch.from_numpy(imgs))
    for k in range(3):
        close(down[k], jip.gaussian_blur_down(jnp.asarray(imgs[k])))
        close(grads[k], jip.sobel_gradients(jnp.asarray(imgs[k])))


def test_bilinear_sample_and_grad():
    rng = np.random.RandomState(2)
    H, W = 24, 32
    img = rng.rand(H, W).astype(np.float32)
    pix = np.concatenate([
        rng.uniform(-2, W + 2, (200, 1)), rng.uniform(-2, H + 2, (200, 1))],
        axis=1).astype(np.float32)
    # exercise the clamped last row/column exactly
    pix[:4] = [[W - 1, 3.5], [W - 0.5, 2.25], [4.5, H - 1], [W - 0.25, H - 0.5]]
    close(tip.bilinear_sample(torch.from_numpy(img), torch.from_numpy(pix)),
          jip.bilinear_sample(jnp.asarray(img), jnp.asarray(pix)))
    for a, b in zip(tip.bilinear_sample_grad(torch.from_numpy(img), torch.from_numpy(pix)),
                    jip.bilinear_sample_grad(jnp.asarray(img), jnp.asarray(pix))):
        close(a, b)


def test_batched_bilinear_sample_grad():
    rng = np.random.RandomState(3)
    imgs = rng.rand(2, 16, 20).astype(np.float32)
    pix = rng.uniform(0, 16, (2, 50, 2)).astype(np.float32)
    out = tip.bilinear_sample_grad(torch.from_numpy(imgs), torch.from_numpy(pix))
    for k in range(2):
        ref = jip.bilinear_sample_grad(jnp.asarray(imgs[k]), jnp.asarray(pix[k]))
        for a, b in zip(out, ref):
            close(a[k], b)


def test_update_depth():
    rng = np.random.RandomState(4)
    prx = rng.uniform(0.3, 0.7, (12, 16)).astype(np.float32)
    jac = (0.05 * rng.standard_normal((12, 16, 8))).astype(np.float32)
    code = rng.standard_normal(8).astype(np.float32)
    # depth = avg / prx - avg reaches ~25 here: hold it to 1e-6 relative
    # (the code contraction sums in another order), not 1e-6 absolute
    np.testing.assert_allclose(
        tip.update_depth(torch.from_numpy(code), torch.from_numpy(prx),
                         torch.from_numpy(jac), 2.0).numpy(),
        np.asarray(jip.update_depth(jnp.asarray(code), jnp.asarray(prx),
                                    jnp.asarray(jac), 2.0)),
        rtol=TOL, atol=TOL)
