"""Plain PyTorch twins of the fused linearisation kernels
(deepfactors_tpu_torch/ops/kernels/sfm_gram.py) against the JAX package:
(a) its Pallas kernels in interpret mode, (b) its XLA reference path
(dense_sfm.se3_step / sfm_step_batch). Inputs are numpy, seeded, identical
for both packages.

Tolerance: 1e-4 of max|JtJ| (and of max|Jtr|), the CPU tolerance of
tests/test_sfm_fused.py — both sides are fp32 with a different summation
order; inlier counts are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.ops import dense_sfm as jds
from deepfactors_tpu.ops.pallas import sfm_kernel as jsk
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.ops.kernels import sfm_gram as tsg

torch.set_num_threads(2)
TOL = 1e-4


def make_problem(H, W, CS, K, P, seed=0):
    """tests/test_sfm_fused.make_problem, plus inactive slots."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    imgs = np.stack([0.5 + 0.3 * np.sin(xs / 7 + k) * np.cos(ys / 5 + 0.3 * k)
                     for k in range(K)]).astype(np.float32)
    grads = np.stack([np.stack(np.gradient(im)[::-1], axis=-1)
                      for im in imgs]).astype(np.float32)
    prx0 = (0.45 + 0.1 * rng.rand(K, H, W)).astype(np.float32)
    jac = (0.02 * rng.standard_normal((K, H, W, CS))).astype(np.float32)
    codes = (0.1 * rng.standard_normal((K, CS))).astype(np.float32)
    prx = prx0 + np.einsum("khwc,kc->khw", jac, codes)
    dpt = (2.0 / prx - 2.0).astype(np.float32)
    qs, ts = [], []
    for _ in range(K):
        w = 0.02 * rng.standard_normal(3)
        q = np.array([1.0, w[0] / 2, w[1] / 2, w[2] / 2])
        qs.append(q / np.linalg.norm(q))
        ts.append(0.05 * rng.standard_normal(3))
    q = np.stack(qs).astype(np.float32)
    t = np.stack(ts).astype(np.float32)
    src = rng.randint(0, K, P).astype(np.int32)
    dst = ((src + 1 + rng.randint(0, K - 1, P)) % K).astype(np.int32)
    active = (rng.rand(P) < 0.7).astype(np.int32)
    active[0] = 1
    return dict(imgs=imgs, grads=grads, prx0=prx0, jac=jac, codes=codes,
                dpt=dpt, q=q, t=t, src=src, dst=dst, active=active)


def cams(H, W):
    kw = dict(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2, width=W, height=H)
    return JCam.create(**kw), TCam.create(**kw)


T = torch.from_numpy


def params_both(pr, cam_j, cam_t, border, min_dpt, huber, avg, kind):
    qs, ts, src, dst = pr["q"], pr["t"], pr["src"], pr["dst"]
    if kind == "se3":
        pj = jax.vmap(jse3.relative_pose)(JSE3(jnp.asarray(qs[dst]), jnp.asarray(ts[dst])),
                                          JSE3(jnp.asarray(qs[src]), jnp.asarray(ts[src])))
        pt = tse3.relative_pose(TSE3(T(qs[dst]), T(ts[dst])),
                                TSE3(T(qs[src]), T(ts[src])))
        jac_t = None
    else:
        pj, _, _ = jax.vmap(jse3.relative_pose_jacobians)(
            JSE3(jnp.asarray(qs[dst]), jnp.asarray(ts[dst])),
            JSE3(jnp.asarray(qs[src]), jnp.asarray(ts[src])))
        pt, j1, j0 = tse3.relative_pose_jacobians(TSE3(T(qs[dst]), T(ts[dst])),
                                                  TSE3(T(qs[src]), T(ts[src])))
        jac_t = (j0, j1)
    kj = jsk.make_sfm_params(pj, cam_j, border, min_dpt, huber, avg)
    kt = tsg.make_sfm_params(pt, cam_t, border, min_dpt, huber, avg)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6)
    return kj, kt, jac_t


def rel_err(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)


@pytest.mark.parametrize("H,W", [(48, 128), (48, 64)])
@pytest.mark.parametrize("grad_mode", ["interp", "sampled"])
def test_se3_gram_plain_matches_pallas_interpret(H, W, grad_mode):
    pr = make_problem(H, W, 4, 3, 5, seed=7)
    cj, ct = cams(H, W)
    kj, kt, _ = params_both(pr, cj, ct, 1, 0.0, 0.3, 2.0, "se3")
    Gj = np.asarray(jsk.se3_gram_batch(
        kj, jnp.asarray(pr["src"]), jnp.asarray(pr["dst"]),
        jnp.asarray(pr["imgs"]), jnp.asarray(pr["dpt"]), jnp.asarray(pr["imgs"]),
        jnp.asarray(pr["grads"][..., 0]), jnp.asarray(pr["grads"][..., 1]),
        active=jnp.asarray(pr["active"]), grad_mode=grad_mode, interpret=True))
    Gt = tsg.se3_gram_batch(
        kt, T(pr["src"]), T(pr["dst"]), T(pr["imgs"]), T(pr["dpt"]), T(pr["imgs"]),
        T(pr["grads"][..., 0].copy()), T(pr["grads"][..., 1].copy()),
        active=T(pr["active"]), grad_mode=grad_mode).numpy()
    assert tsg.LAUNCHES["se3_gram_batch"] == 0
    assert np.all(Gt[pr["active"] == 0] == 0)
    np.testing.assert_array_equal(Gt[:, 7, 7], Gj[:, 7, 7])
    assert rel_err(Gt[:, :6, :6], Gj[:, :6, :6]) < TOL
    assert rel_err(Gt[:, :6, 6], Gj[:, :6, 6]) < TOL
    np.testing.assert_allclose(Gt[:, 6, 6], Gj[:, 6, 6], rtol=1e-4)


@pytest.mark.parametrize("grad_mode", ["interp", "sampled"])
def test_se3_gram_plain_matches_xla_se3_step(grad_mode):
    H, W = 48, 64
    pr = make_problem(H, W, 4, 3, 4, seed=3)
    pr["active"][:] = 1
    cj, ct = cams(H, W)
    kj, kt, _ = params_both(pr, cj, ct, 1, 0.0, 0.3, 2.0, "se3")
    Gt = tsg.se3_gram_batch(
        kt, T(pr["src"]), T(pr["dst"]), T(pr["imgs"]), T(pr["dpt"]), T(pr["imgs"]),
        T(pr["grads"][..., 0].copy()), T(pr["grads"][..., 1].copy()),
        grad_mode=grad_mode).numpy()
    for p in range(4):
        s, d = pr["src"][p], pr["dst"][p]
        pose_10 = jse3.relative_pose(JSE3(jnp.asarray(pr["q"][d]), jnp.asarray(pr["t"][d])),
                                     JSE3(jnp.asarray(pr["q"][s]), jnp.asarray(pr["t"][s])))
        ref = jds.se3_step(pose_10, cj, jnp.asarray(pr["imgs"][s]), jnp.asarray(pr["imgs"][d]),
                           jnp.asarray(pr["dpt"][s]), jnp.asarray(pr["grads"][d]), 0.3,
                           grad_mode=grad_mode)
        assert Gt[p, 7, 7] == float(ref.inliers)
        assert rel_err(Gt[p, :6, :6], np.asarray(ref.JtJ)) < TOL
        assert rel_err(Gt[p, :6, 6], np.asarray(ref.Jtr)) < TOL
        np.testing.assert_allclose(Gt[p, 6, 6], float(ref.residual), rtol=1e-4)


def _sfm_pair(pr, H, W, CS, grad_mode, loss, from_prox):
    cj, ct = cams(H, W)
    huber = 0.1
    kj, kt, (j0, j1) = params_both(pr, cj, ct, 2, 0.01, huber, 2.0, "sfm")
    codes = pr["codes"][pr["src"]]
    dpool = pr["prx0"] if from_prox else pr["dpt"]
    jacT = np.ascontiguousarray(np.transpose(pr["jac"], (0, 3, 1, 2)))
    Gj = np.asarray(jsk.sfm_gram_batch(
        kj, jnp.asarray(pr["src"]), jnp.asarray(pr["dst"]), jnp.asarray(pr["imgs"]),
        jnp.asarray(dpool), jnp.asarray(jacT), jnp.asarray(pr["imgs"]),
        jnp.asarray(pr["grads"][..., 0]), jnp.asarray(pr["grads"][..., 1]),
        active=jnp.asarray(pr["active"]),
        codes=jnp.asarray(codes) if from_prox else None,
        grad_mode=grad_mode, loss=loss, interpret=True))
    Gt = tsg.sfm_gram_batch(
        kt, T(pr["src"]), T(pr["dst"]), T(pr["imgs"]), T(dpool), T(jacT),
        T(pr["imgs"]), T(pr["grads"][..., 0].copy()), T(pr["grads"][..., 1].copy()),
        active=T(pr["active"]), codes=T(codes) if from_prox else None,
        grad_mode=grad_mode, loss=loss)
    return Gj, Gt, j0, j1


@pytest.mark.parametrize("H,W", [(48, 128), (48, 64)])
@pytest.mark.parametrize("grad_mode,loss,from_prox", [
    ("interp", "huber", False), ("interp", "tukey", True),
    ("sampled", "huber", True), ("sampled", "tukey", False)])
def test_sfm_gram_plain_matches_pallas_interpret(H, W, grad_mode, loss,
                                                 from_prox):
    CS = 8
    pr = make_problem(H, W, CS, 4, 6)
    Gj, Gt, _, _ = _sfm_pair(pr, H, W, CS, grad_mode, loss, from_prox)
    Gt = Gt.numpy()
    assert tsg.LAUNCHES["sfm_gram_batch"] == 0
    assert np.all(Gt[pr["active"] == 0] == 0)
    DB = 6 + CS
    np.testing.assert_array_equal(Gt[:, DB + 1, DB + 1], Gj[:, DB + 1, DB + 1])
    assert rel_err(Gt[:, :DB, :DB], Gj[:, :DB, :DB]) < TOL
    assert rel_err(Gt[:, :DB, DB], Gj[:, :DB, DB]) < TOL
    np.testing.assert_allclose(Gt[:, DB, DB], Gj[:, DB, DB], rtol=1e-4)


@pytest.mark.parametrize("grad_mode,loss", [("interp", "tukey"),
                                            ("sampled", "huber")])
def test_sfm_gram_system_matches_xla_sfm_step_batch(grad_mode, loss):
    """plain sfm_gram_batch + system_from_gram against JAX sfm_step_batch
    (materialised depth at the codes)."""
    H, W, CS = 48, 64, 8
    pr = make_problem(H, W, CS, 4, 5, seed=1)
    pr["active"][:] = 1
    _, Gt, j0, j1 = _sfm_pair(pr, H, W, CS, grad_mode, loss, True)
    JtJ, Jtr, res, inl = (x.numpy() for x in tsg.system_from_gram(Gt, j0, j1, CS))
    cj, _ = cams(H, W)
    src, dst = pr["src"], pr["dst"]
    params = jds.SfmParams(huber_delta=0.1, avg_dpt=2.0, min_dpt=0.01,
                           valid_border=2)
    ref = jds.sfm_step_batch(
        JSE3(jnp.asarray(pr["q"][src]), jnp.asarray(pr["t"][src])),
        JSE3(jnp.asarray(pr["q"][dst]), jnp.asarray(pr["t"][dst])),
        jnp.asarray(pr["codes"][src]), cj, jnp.asarray(pr["imgs"][src]),
        jnp.asarray(pr["imgs"][dst]), jnp.asarray(pr["dpt"][src]),
        jnp.zeros((5, H, W)), jnp.asarray(pr["jac"][src]),
        jnp.asarray(pr["grads"][dst]), params, grad_mode=grad_mode, loss=loss)
    np.testing.assert_array_equal(inl, np.asarray(ref.inliers))
    assert rel_err(JtJ, np.asarray(ref.JtJ)) < TOL
    assert rel_err(Jtr, np.asarray(ref.Jtr)) < TOL
    np.testing.assert_allclose(res, np.asarray(ref.residual), rtol=1e-3)
    np.testing.assert_array_equal(JtJ, np.swapaxes(JtJ, -1, -2))


@pytest.mark.parametrize("grad_mode,loss", [("interp", "tukey"),
                                            ("sampled", "huber")])
def test_sfm_step_batch_matches_xla_sfm_step_batch(grad_mode, loss):
    """the port's XLA-branch sfm_step_batch against JAX's, same inputs."""
    from deepfactors_tpu_torch.ops import dense_sfm as tds

    H, W, CS, P = 48, 64, 8, 3
    pr = make_problem(H, W, CS, 4, P, seed=2)
    cj, ct = cams(H, W)
    src, dst = pr["src"], pr["dst"]
    args = (pr["codes"][src], pr["imgs"][src], pr["imgs"][dst], pr["dpt"][src],
            np.zeros((P, H, W), np.float32), pr["jac"][src], pr["grads"][dst])
    kw = dict(grad_mode=grad_mode, loss=loss)
    ref = jds.sfm_step_batch(
        JSE3(jnp.asarray(pr["q"][src]), jnp.asarray(pr["t"][src])),
        JSE3(jnp.asarray(pr["q"][dst]), jnp.asarray(pr["t"][dst])),
        jnp.asarray(args[0]), cj, *(jnp.asarray(a) for a in args[1:]),
        jds.SfmParams(huber_delta=0.1, avg_dpt=2.0, min_dpt=0.01,
                      valid_border=2), **kw)
    out = tds.sfm_step_batch(
        TSE3(T(pr["q"][src]), T(pr["t"][src])),
        TSE3(T(pr["q"][dst]), T(pr["t"][dst])),
        T(args[0]), ct, *(T(np.ascontiguousarray(a)) for a in args[1:]),
        tds.SfmParams(huber_delta=0.1, avg_dpt=2.0, min_dpt=0.01,
                      valid_border=2), **kw)
    JtJ, Jtr, res, inl = (x.numpy() for x in out)
    np.testing.assert_array_equal(inl, np.asarray(ref.inliers))
    assert rel_err(JtJ, np.asarray(ref.JtJ)) < TOL
    assert rel_err(Jtr, np.asarray(ref.Jtr)) < TOL
    np.testing.assert_allclose(res, np.asarray(ref.residual), rtol=1e-4)


def test_system_from_gram_matches_jax():
    rng = np.random.RandomState(5)
    P, CS = 3, 8
    B = rng.standard_normal((P, CS + 8, 50)).astype(np.float32)
    G = np.einsum("pin,pjn->pij", B, B)
    j0 = rng.standard_normal((P, 6, 6)).astype(np.float32)
    j1 = rng.standard_normal((P, 6, 6)).astype(np.float32)
    out_j = jsk.system_from_gram(jnp.asarray(G), jnp.asarray(j0), jnp.asarray(j1), CS)
    out_t = tsg.system_from_gram(T(G), T(j0), T(j1), CS)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(np.asarray(b))))


def test_wrappers_reject_unknown_modes():
    pr = make_problem(16, 32, 4, 2, 2)
    _, ct = cams(16, 32)
    kt = tsg.make_sfm_params(TSE3(T(pr["q"][:2]), T(pr["t"][:2])), ct, 1, 0, .3, 2)
    with pytest.raises(ValueError):
        tsg.se3_gram_batch(kt, T(pr["src"]), T(pr["dst"]), T(pr["imgs"]),
                           T(pr["dpt"]), T(pr["imgs"]), grad_mode="bogus")


# ----------------------------------------------------------------------------
# what surrounds the CUDA kernels: the launch plan, the tile map, the order
# of the kernel's sums. These tests check the plan, which the kernels are
# handed and derive nothing of (strips, tile table, row map, slices, shared
# memory), not the kernels: those run only on a card, where chip_smoke.py
# holds them against the twins.
# ----------------------------------------------------------------------------

SIZES = [(192, 256), (96, 128), (48, 64), (90, 122), (89, 121)]
ERR_PLAN_CASES = [(name, P, 0) for name in ("sfm_error_batch", "se3_warp_batch")
                  for P in (1, 2, 3, 16, 64, 128)]


@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("name,P,CS", [("se3_gram_batch", 1, 0),
                                       ("se3_gram_batch", 8, 0),
                                       ("sfm_gram_batch", 128, 32),
                                       ("sfm_gram_batch", 3, 64),
                                       ("bilinear_warp_planes", 1, 0)]
                         + ERR_PLAN_CASES)
def test_launch_plan_covers_every_pixel_once(name, P, CS, H, W):
    plan = tsg.launch_plan(name, P, H, W, CS)
    N = H * W
    seen = np.zeros(N, np.int32)
    if name == "bilinear_warp_planes":
        # thread t of 256 takes pixel begin + t; no scratch, no tickets
        assert plan.px_per_blk == tsg.THREADS
        assert plan.grid == (plan.nblk, 1)
        assert plan.part_shape == () and plan.ticket_shape == ()
        for blk in range(plan.nblk):
            begin = blk * plan.px_per_blk
            assert begin < N, "an empty block"
            seen[begin:min(N, begin + tsg.THREADS)] += 1
        assert (seen == 1).all()
        return
    if name in ("sfm_error_batch", "se3_warp_batch"):
        # the last block reads one strip's partial a thread
        assert plan.nblk <= tsg.THREADS and plan.px_per_blk % tsg.THREADS == 0
        assert plan.part_shape == (P, plan.nblk, 2)
    for blk in range(plan.nblk):
        begin, end = blk * plan.px_per_blk, min(N, (blk + 1) * plan.px_per_blk)
        assert begin < end, "an empty strip"
        if name != "sfm_gram_batch":
            # thread t of 256 walks begin + t, begin + t + 256, ...
            for t in range(tsg.THREADS):
                seen[begin + t:end:tsg.THREADS] += 1
            continue
        # tiles of tile_px pixels; slice s walks pixels s, s + nslices, ...
        assert plan.tile_px == plan.nslices * plan.steps <= tsg.THREADS
        assert plan.tile_px % 4 == 0 and plan.px_per_blk % plan.tile_px == 0
        for tile in range(begin, end, plan.tile_px):
            for s in range(plan.nslices):
                px = tile + s + plan.nslices * np.arange(plan.steps)
                np.add.at(seen, px[px < end], 1)
    assert (seen == 1).all()
    assert set(plan.grid) == {plan.nblk, P} or plan.nblk == P
    assert plan.part_shape[:2] == (P, plan.nblk) and plan.ticket_shape == (P,)


@pytest.mark.parametrize("CS", [8, 32, 64, 5])
def test_tile_map_covers_the_upper_triangle_once(CS):
    """The writer of G, replayed from the table the plan hands the kernel
    (tile -> block row, tile -> block column, shared-memory row -> row of
    G): every entry of the R x R matrix is written exactly once (the
    triangle and its mirror), padding rows never."""
    plan = tsg.launch_plan("sfm_gram_batch", 4, 48, 64, CS)
    R, T = CS + 8, tsg.TILE
    assert plan.R == R and plan.Rp % T == 0 and 0 <= plan.Rp - R < T
    assert len(plan.tiles) <= plan.lanes and plan.lanes * plan.nslices <= tsg.THREADS
    assert plan.part_shape[2] == len(plan.tiles) * T * T
    n = len(plan.tiles)
    assert len(plan.table) == 2 * n + plan.Rp
    ti_of, tj_of, row_of = (plan.table[:n], plan.table[n:2 * n],
                            plan.table[2 * n:])
    assert tuple(zip(ti_of, tj_of)) == plan.tiles
    assert all(r == -1 for r in row_of[R:]), "a padding row maps into G"
    written = np.zeros((R, R), np.int32)
    rows = sorted(tsg.public_row(q, CS) for q in range(R))
    assert rows == list(range(R)), "public_row is no permutation"
    assert [tsg.public_row(q, CS) for q in (0, CS, CS + 6, CS + 7)] == \
        [6, 0, CS + 6, CS + 7]
    for ti, tj in zip(ti_of, tj_of):
        assert ti <= tj
        for a in range(T):
            for b in range(T):
                qi, qj = T * ti + a, T * tj + b
                gi, gj = row_of[qi], row_of[qj]
                if (ti == tj and qj < qi) or gi < 0 or gj < 0:
                    continue
                assert (gi, gj) == (tsg.public_row(qi, CS),
                                    tsg.public_row(qj, CS))
                written[gi, gj] += 1
                if gi != gj:
                    written[gj, gi] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("CS", [1, 8, 32, 40, 64])
def test_launch_plan_shared_memory_fits(CS):
    plan = tsg.launch_plan("sfm_gram_batch", 128, 192, 256, CS)
    rows = plan.tile_px * plan.stride
    assert plan.stride >= plan.Rp and plan.stride % 8 == 4, \
        "float4 stores of a quarter warp must hit eight bank groups"
    assert plan.stage_off % 4 == 0, "the bulk copies land 16-byte aligned"
    assert plan.stage_off >= max(rows, 32 * tsg.THREADS), \
        "the stage overlaps the rows or the block reduction"
    assert plan.smem_bytes >= 4 * (plan.stage_off + (CS + 2) * 256)
    assert plan.smem_bytes <= 227 * 1024
    if CS <= 32:     # two blocks an SM on the main path
        assert 2 * (plan.smem_bytes + 1024) <= 227 * 1024


def _fma32(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _capture_rows(monkeypatch):
    """Make the twins hand out their rows [P, R, N] beside G."""
    got = {}
    gram = tsg._gram

    def spy(rows, active):
        got["B"] = torch.stack(rows, dim=1).numpy()
        return gram(rows, active)

    monkeypatch.setattr(tsg, "_gram", spy)
    return got


def _blocks_within_tol(Gk, Gp, DB):
    np.testing.assert_array_equal(Gk[:, DB + 1, DB + 1], Gp[:, DB + 1, DB + 1])
    for p in range(Gp.shape[0]):
        assert rel_err(Gk[p, :DB, :DB], Gp[p, :DB, :DB]) < TOL
        assert rel_err(Gk[p, :DB, DB], Gp[p, :DB, DB]) < TOL
        assert abs(Gk[p, DB, DB] - Gp[p, DB, DB]) < TOL * abs(Gp[p, DB, DB])


def test_sfm_gram_kernel_summation_order_within_tolerance(monkeypatch):
    """The reason for the kernel-vs-twin tolerance of 1e-4 per block: the
    twin's rows summed again in fp32 in the CUDA kernel's order (fmaf over
    the pixels of a slice, slices in order, strips in order) against the
    twin's matmul, at 48x64."""
    H, W, CS = 48, 64, 8
    pr = make_problem(H, W, CS, 4, 3, seed=4)
    pr["active"][:] = 1
    got = _capture_rows(monkeypatch)
    _, Gp, _, _ = _sfm_pair(pr, H, W, CS, "interp", "huber", True)
    B, Gp = got["B"], Gp.numpy()
    P, R, N = B.shape
    plan = tsg.launch_plan("sfm_gram_batch", P, H, W, CS)
    G = np.zeros((P, R, R), np.float32)
    for blk in range(plan.nblk):
        begin, end = blk * plan.px_per_blk, min(N, (blk + 1) * plan.px_per_blk)
        acc = np.zeros((plan.nslices, P, R, R), np.float32)
        for tile in range(begin, end, plan.tile_px):
            rows = np.zeros((P, R, plan.tile_px), np.float32)
            n = min(plan.tile_px, end - tile)
            rows[:, :, :n] = B[:, :, tile:tile + n]
            for k in range(plan.steps):
                b = rows[:, :, k * plan.nslices:(k + 1) * plan.nslices]
                b = np.moveaxis(b, 2, 0)                       # [slice, P, R]
                acc = _fma32(b[..., :, None], b[..., None, :], acc)
        strip = np.zeros((P, R, R), np.float32)
        for s in range(plan.nslices):
            strip = strip + acc[s]
        G = G + strip
    _blocks_within_tol(G, Gp, 6 + CS)
    assert np.abs(G - Gp).max() > 0, "the orders should differ in the last bits"


def test_se3_gram_kernel_summation_order_within_tolerance(monkeypatch):
    """The same for se3_gram_batch: one pixel a thread, 7 groups of threads
    summed in runs, then the groups, then the strips in 7 runs."""
    H, W = 48, 64
    pr = make_problem(H, W, 4, 3, 4, seed=3)
    pr["active"][:] = 1
    _, ct = cams(H, W)
    kt = tsg.make_sfm_params(
        tse3.relative_pose(TSE3(T(pr["q"][pr["dst"]]), T(pr["t"][pr["dst"]])),
                           TSE3(T(pr["q"][pr["src"]]), T(pr["t"][pr["src"]]))),
        ct, 1, 0.0, 0.3, 2.0)
    got = _capture_rows(monkeypatch)
    Gp = tsg.se3_gram_batch(kt, T(pr["src"]), T(pr["dst"]), T(pr["imgs"]),
                            T(pr["dpt"]), T(pr["imgs"]), grad_mode="interp").numpy()
    B = got["B"]
    P, R, N = B.shape
    plan = tsg.launch_plan("se3_gram_batch", P, H, W)

    def grouped(vals):                       # [count, ...] -> sum in 7 runs
        run = -(-len(vals) // 7)
        total = np.zeros_like(vals[0])
        for g in range(7):
            s = np.zeros_like(vals[0])
            for v in vals[g * run:(g + 1) * run]:
                s = s + v
            total = total + s
        return total

    strips = []
    for blk in range(plan.nblk):
        begin, end = blk * plan.px_per_blk, min(N, (blk + 1) * plan.px_per_blk)
        acc = np.zeros((tsg.THREADS, P, R, R), np.float32)
        for first in range(begin, end, tsg.THREADS):
            b = np.zeros((tsg.THREADS, P, R), np.float32)
            n = min(tsg.THREADS, end - first)
            b[:n] = np.moveaxis(B[:, :, first:first + n], 2, 0)
            acc = _fma32(b[..., :, None], b[..., None, :], acc)
        strips.append(grouped(acc))
    _blocks_within_tol(grouped(np.stack(strips)), Gp, 6)


def test_make_sfm_params_keeps_its_constants_on_the_device():
    """The constant tail of a params row is built once per (camera, border,
    min_dpt, huber, avg_dpt, device) and gives the same bits as a row built
    from the host on every call."""
    pr = make_problem(16, 32, 4, 3, 3)
    _, ct = cams(16, 32)
    pose = TSE3(T(pr["q"]), T(pr["t"]))
    tsg._CONST_ROWS.clear()
    first = tsg.make_sfm_params(pose, ct, 2, 0.01, 0.1, 2.0)
    (row,) = tsg._CONST_ROWS.values()
    again = tsg.make_sfm_params(pose, ct, 2, 0.01, 0.1, 2.0)
    assert list(tsg._CONST_ROWS.values())[0] is row and len(tsg._CONST_ROWS) == 1
    tsg.make_sfm_params(pose, ct, 2, 0.01, 0.3, 2.0)
    assert len(tsg._CONST_ROWS) == 2
    P = 3
    const = torch.tensor([ct.fx, ct.fy, ct.u0, ct.v0, 2.0, 0.01, 0.1, 2.0],
                         dtype=torch.float32).expand(P, 8)
    want = torch.cat([tse3.quat_to_matrix(pose.q).reshape(P, 9), pose.t, const,
                      torch.zeros((P, tsg.PARAM_DIM - 20))], dim=-1)
    assert first.shape == (P, tsg.PARAM_DIM)
    assert torch.equal(first, want) and torch.equal(again, want)
    first[:, 12:] = -1.0                      # a caller's row is its own
    assert torch.equal(tsg.make_sfm_params(pose, ct, 2, 0.01, 0.1, 2.0), want)


def test_ticket_buffer_is_per_stream_and_dropped_after_a_failure():
    """The wrappers' ticket buffers: one per (device, stream), reused while
    it is large enough, and thrown away after a failed launch so that the
    next call starts from zeros."""
    dev = torch.device("cpu")
    tsg._TICKETS.clear()
    a = tsg._tickets(dev, 1, 8)
    assert a.dtype == torch.int32 and a.numel() >= 8 and not a.any()
    assert tsg._tickets(dev, 1, 4) is a
    assert tsg._tickets(dev, 2, 8) is not a, "two streams share tickets"
    assert tsg._tickets(dev, 1, a.numel() + 1).numel() > a.numel()
    a = tsg._tickets(dev, 1, 8)
    a[3] = 2                                  # what a failed launch may leave
    tsg._drop_tickets(dev, 1)
    b = tsg._tickets(dev, 1, 8)
    assert b is not a and not b.any()
    tsg._TICKETS.clear()
