"""deepfactors_tpu_torch.solver.system against the JAX package on a seeded
window: assembly of per-factor systems, diagonal priors, masking of
inactive variables, the damped dense solve and the Schur solve over the
code blocks.

Tolerance: assembly and priors 1e-5 relative (scatter-adds of the same
fp32 terms in another order); solves 1e-4 relative to max|dx| (fp32
Cholesky of a well-conditioned window)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.solver import system as jsys
from deepfactors_tpu_torch.solver import system as tsys

torch.set_num_threads(2)
T = torch.from_numpy


def window(K=4, CS=6, P=7, F=2, seed=0):
    """Factors over [poses 6K | codes CS·K | frame poses 6F]; the last
    factor is inactive and carries garbage, which must not leak."""
    rng = np.random.RandomState(seed)
    Df = 12 + CS
    src = rng.randint(0, K, P).astype(np.int32)
    dst = ((src + 1 + rng.randint(0, K - 1, P)) % K).astype(np.int32)
    Hs, bs = [], []
    for _ in range(P):
        J = rng.randn(40, Df).astype(np.float32)
        Hs.append(J.T @ J)
        bs.append(J.T @ rng.randn(40).astype(np.float32))
    Hs, bs = np.stack(Hs), np.stack(bs)
    Hs[-1] = 1e6
    active = np.ones(P, bool)
    active[-1] = False
    return dict(K=K, CS=CS, F=F, D=6 * K + CS * K + 6 * F, src=src, dst=dst,
                Hs=Hs, bs=bs, active=active, rng=rng)


def both(w):
    D, K, CS = w["D"], w["K"], w["CS"]
    ij = jsys.factor_slot_indices(jnp.asarray(w["src"]), jnp.asarray(w["dst"]), K, CS)
    it = tsys.factor_slot_indices(T(w["src"]).long(), T(w["dst"]).long(), K, CS)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    gj = jsys.assemble(D, jnp.asarray(w["Hs"]), jnp.asarray(w["bs"]), ij,
                       jnp.asarray(w["active"]))
    gt = tsys.assemble(D, T(w["Hs"]), T(w["bs"]), it, T(w["active"]))
    # a well-posed window: unit prior on every variable
    r = w["rng"].randn(D).astype(np.float32)
    gj = jsys.add_diagonal_prior(gj, jnp.arange(D, dtype=jnp.int32), jnp.full(D, 1.0),
                                 jnp.asarray(r))
    gt = tsys.add_diagonal_prior(gt, torch.arange(D), torch.full((D,), 1.0), T(r))
    return gj, gt


def rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_assemble_and_prior_match_jax():
    gj, gt = both(window())
    assert np.isfinite(gt.H.numpy()).all()
    assert rel(gt.H.numpy(), np.asarray(gj.H)) < 1e-5
    assert rel(gt.b.numpy(), np.asarray(gj.b)) < 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_solve_damped_matches_jax(masked):
    w = window(seed=1)
    gj, gt = both(w)
    if masked:
        m = np.ones(w["D"], bool)
        m[[3, 10, w["D"] - 1]] = False
        gj = jsys.mask_inactive(gj, jnp.asarray(m))
        gt = tsys.mask_inactive(gt, T(m))
        assert rel(gt.H.numpy(), np.asarray(gj.H)) < 1e-5
    dj = np.asarray(jsys.solve_damped(gj, jnp.asarray(1e-4)))
    dt = tsys.solve_damped(gt, 1e-4).numpy()
    assert rel(dt, dj) < 1e-4
    if masked:
        assert np.all(np.abs(dt[~m]) < 1e-6)


@pytest.mark.parametrize("F", [0, 2])
def test_solve_schur_codes_matches_jax_and_dense(F):
    w = window(F=F, seed=2)
    gj, gt = both(w)
    dj = np.asarray(jsys.solve_schur_codes(gj, w["K"], w["CS"], jnp.asarray(1e-4)))
    dt = tsys.solve_schur_codes(gt, w["K"], w["CS"], 1e-4).numpy()
    assert rel(dt, dj) < 1e-4
    assert rel(dt, tsys.solve_damped(gt, 1e-4).numpy()) < 1e-3


def test_inactive_nan_factor_does_not_leak():
    """The port masks inactive factors with a select, so even a NaN in an
    inactive slot stays out of the system."""
    w = window(seed=3)
    Hs = w["Hs"].copy()
    Hs[-1] = np.nan
    it = tsys.factor_slot_indices(T(w["src"]).long(), T(w["dst"]).long(), w["K"], w["CS"])
    g = tsys.assemble(w["D"], T(Hs), T(w["bs"]), it, T(w["active"]))
    assert torch.isfinite(g.H).all() and torch.isfinite(g.b).all()


def test_non_pd_block_gives_nan_not_an_exception():
    """torch.linalg.cholesky raises on a non-PD matrix; the port uses
    cholesky_ex so the solve yields NaN like the JAX package."""
    D = 6
    g = tsys.GlobalSystem(-torch.eye(D), torch.ones(D))
    assert torch.isnan(tsys.solve_damped(g, 0.0)).all()
    assert np.isnan(np.asarray(jsys.solve_damped(
        jsys.GlobalSystem(-jnp.eye(D), jnp.ones(D)), jnp.asarray(0.0)))).all()
