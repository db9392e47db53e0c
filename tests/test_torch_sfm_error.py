"""Plain PyTorch twins of the error-evaluation and warp-render kernels
(deepfactors_tpu_torch/ops/kernels/sfm_error.py) against the JAX package:
(a) its Pallas kernels ``sfm_error_batch`` / ``se3_warp_batch`` in interpret
mode, (b) its XLA references ``dense_sfm.sfm_evaluate_error`` /
``dense_sfm.se3_warp``; then ``factors.photometric_error_batch`` and
``dense_sfm.se3_warp`` of the port against their JAX counterparts. Inputs
are numpy, seeded, identical for both packages.

Tolerances (those of tests/test_sfm_fused.py on the CPU): inlier counts
exact; residual rtol 1e-3 (fp32 sums in a different order, and the XLA
reference interpolates as v00·(1-w) + v01·w where the kernels use
v00 + w·(v01 - v00)); warped image atol 1e-5; inactive slots exactly 0."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sfm_gram import T, _fma32, cams, make_problem, params_both

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import camera_pyramid as jcam_pyr
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.mapping import factors as jfct
from deepfactors_tpu.mapping import map_state as jms
from deepfactors_tpu.ops import dense_sfm as jds
from deepfactors_tpu.ops.pallas import sfm_kernel as jsk
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry.camera import camera_pyramid as tcam_pyr
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping import factors as tfct
from deepfactors_tpu_torch.mapping import map_state as tms
from deepfactors_tpu_torch.ops import dense_sfm as tds
from deepfactors_tpu_torch.ops.kernels import sfm_error as tse
from deepfactors_tpu_torch.ops.kernels import sfm_gram as tsg

torch.set_num_threads(2)
RES_RTOL, WARP_ATOL = 1e-3, 1e-5
SIZES = [(48, 64, 4), (24, 32, 3)]      # H, W, P


def _problem(H, W, P, seed):
    pr = make_problem(H, W, 4, 3, P, seed=seed)
    cj, ct = cams(H, W)
    # the evaluation kernels take border 1, min_dpt 0 from the params row
    kj, kt, _ = params_both(pr, cj, ct, 1, 0.0, 0.1, 2.0, "se3")
    return pr, cj, ct, kj, kt


def _pools_j(pr):
    return (jnp.asarray(pr["src"]), jnp.asarray(pr["dst"]),
            jnp.asarray(pr["imgs"]), jnp.asarray(pr["dpt"]),
            jnp.asarray(pr["imgs"]))


def _pools_t(pr):
    return (T(pr["src"]), T(pr["dst"]), T(pr["imgs"]), T(pr["dpt"]),
            T(pr["imgs"]))


@pytest.mark.parametrize("H,W,P", SIZES)
def test_sfm_error_plain_matches_pallas_interpret(H, W, P):
    pr, _, _, kj, kt = _problem(H, W, P, seed=13)
    rj, ij = jsk.sfm_error_batch(kj, *_pools_j(pr),
                                 active=jnp.asarray(pr["active"]),
                                 interpret=True)
    rt, it = tse.sfm_error_batch(kt, *_pools_t(pr), active=T(pr["active"]))
    on = pr["active"] == 1
    assert on.sum() >= 2 and np.all(np.asarray(ij)[on] > 0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RES_RTOL)
    assert np.all(rt.numpy()[~on] == 0) and np.all(it.numpy()[~on] == 0)


@pytest.mark.parametrize("H,W,P", SIZES)
def test_se3_warp_plain_matches_pallas_interpret(H, W, P):
    pr, _, _, kj, kt = _problem(H, W, P, seed=11)
    wj, rj, ij = jsk.se3_warp_batch(kj, *_pools_j(pr),
                                    active=jnp.asarray(pr["active"]),
                                    interpret=True)
    wt, rt, it = tse.se3_warp_batch(kt, *_pools_t(pr), active=T(pr["active"]))
    on = pr["active"] == 1
    assert wt.shape == (P, H, W) and np.any(wt.numpy()[on] != 0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=WARP_ATOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RES_RTOL)
    for out in (wt, rt, it):
        assert np.all(out.numpy()[~on] == 0)


def _pose(pr, k, SE, conv):
    return SE(conv(pr["q"][k]), conv(pr["t"][k]))


@pytest.mark.parametrize("H,W,P", SIZES)
def test_sfm_error_plain_matches_xla_evaluate_error(H, W, P):
    pr, cj, _, _, kt = _problem(H, W, P, seed=13)
    rt, it = tse.sfm_error_batch(kt, *_pools_t(pr))
    params = jds.SfmParams(huber_delta=0.1, avg_dpt=2.0, min_dpt=0.01,
                           valid_border=2)
    for p in range(P):
        s, d = pr["src"][p], pr["dst"][p]
        ref = jds.sfm_evaluate_error(
            _pose(pr, s, JSE3, jnp.asarray), _pose(pr, d, JSE3, jnp.asarray),
            cj, jnp.asarray(pr["imgs"][s]), jnp.asarray(pr["imgs"][d]),
            jnp.asarray(pr["dpt"][s]), jnp.zeros((H, W)),
            jnp.asarray(pr["grads"][d]), params)
        assert float(it[p]) == float(ref.inliers) > 0
        np.testing.assert_allclose(float(rt[p]), float(ref.residual),
                                   rtol=RES_RTOL)


@pytest.mark.parametrize("H,W,P", SIZES)
def test_se3_warp_plain_matches_xla_se3_warp(H, W, P):
    pr, cj, _, kj, kt = _problem(H, W, P, seed=11)
    wt, rt, it = tse.se3_warp_batch(kt, *_pools_t(pr))
    prev = jds.use_pallas_warp()
    jds.use_pallas_warp(False)
    try:
        for p in range(P):
            s, d = pr["src"][p], pr["dst"][p]
            p10 = jse3.relative_pose(_pose(pr, d, JSE3, jnp.asarray),
                                     _pose(pr, s, JSE3, jnp.asarray))
            w_ref, stats = jds.se3_warp(
                p10, cj, jnp.asarray(pr["imgs"][s]),
                jnp.asarray(pr["imgs"][d]), jnp.asarray(pr["dpt"][s]))
            assert float(it[p]) == float(stats.inliers) > 0
            np.testing.assert_allclose(wt[p].numpy(), np.asarray(w_ref),
                                       atol=WARP_ATOL)
            np.testing.assert_allclose(float(rt[p]), float(stats.residual),
                                       rtol=RES_RTOL)
    finally:
        jds.use_pallas_warp(prev)


@pytest.mark.parametrize("H,W,P", SIZES)
def test_port_se3_warp_matches_jax(H, W, P):
    """``dense_sfm.se3_warp`` of both packages on one keyframe pair."""
    pr, cj, ct, _, _ = _problem(H, W, P, seed=5)
    s, d = int(pr["src"][0]), int(pr["dst"][0])
    pj = jse3.relative_pose(_pose(pr, d, JSE3, jnp.asarray),
                            _pose(pr, s, JSE3, jnp.asarray))
    pt = tse3.relative_pose(_pose(pr, d, TSE3, T), _pose(pr, s, TSE3, T))
    wj, sj = jds.se3_warp(pj, cj, jnp.asarray(pr["imgs"][s]),
                          jnp.asarray(pr["imgs"][d]), jnp.asarray(pr["dpt"][s]))
    wt, st = tds.se3_warp(pt, ct, T(pr["imgs"][s]), T(pr["imgs"][d]),
                          T(pr["dpt"][s]))
    assert wt.shape == (H, W)
    assert float(st.inliers) == float(sj.inliers) > 0
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=WARP_ATOL)
    np.testing.assert_allclose(float(st.residual), float(sj.residual),
                               rtol=RES_RTOL)


def _states(pr, H, W, CS=4):
    """The problem's K keyframes written into a 2-level map of each
    package (level 1 is the level-0 planes subsampled by two)."""
    K = pr["imgs"].shape[0]
    js = jms.create(K, CS, H, W, 2, max_links=4)
    ts = tms.create(K, CS, H, W, 2, max_links=4, device="cpu")
    sub = lambda a, l: np.ascontiguousarray(a[::2, ::2]) if l else a
    for k in range(K):
        lv = [dict(img=sub(pr["imgs"][k], l), grad=sub(pr["grads"][k], l),
                   prx0=sub(pr["prx0"][k], l), jac=sub(pr["jac"][k], l),
                   std=np.zeros_like(sub(pr["imgs"][k], l))) for l in (0, 1)]
        pyr = lambda key, conv: tuple(conv(x[key]) for x in lv)
        js = jms.add_keyframe(
            js, k, _pose(pr, k, JSE3, jnp.asarray), jnp.asarray(pr["codes"][k]),
            pyr("img", jnp.asarray), pyr("grad", jnp.asarray),
            pyr("prx0", jnp.asarray), pyr("jac", jnp.asarray),
            pyr("std", jnp.asarray), 2.0)
        jacT = tuple(T(np.ascontiguousarray(x["jac"].transpose(2, 0, 1)))
                     for x in lv)
        ts = tms.add_keyframe(
            ts, k, _pose(pr, k, TSE3, T), T(pr["codes"][k]), pyr("img", T),
            pyr("grad", T), pyr("prx0", T), jacT, pyr("std", T), 2.0)
    return js, ts


@pytest.mark.parametrize("level", [0, 1])
def test_photometric_error_batch_matches_jax(level):
    H, W, P = 48, 64, 4
    pr, cj, ct, _, _ = _problem(H, W, P, seed=17)
    js, ts = _states(pr, H, W)
    pj = jds.SfmParams(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0,
                       valid_border=2)
    pt = tds.SfmParams(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0,
                       valid_border=2)
    rj, ij = jfct.photometric_error_batch(
        js, jnp.asarray(pr["src"]), jnp.asarray(pr["dst"]), level,
        jcam_pyr(cj, 2)[level], pj)
    rt, it = tfct.photometric_error_batch(
        ts, T(pr["src"]), T(pr["dst"]), level, tcam_pyr(ct, 2)[level], pt)
    assert np.all(np.asarray(ij) > 0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RES_RTOL)


def test_border_and_min_depth_come_from_the_params_row():
    """A wider border in the row drops inliers; the callers pack 1 and 0."""
    H, W, P = 24, 32, 3
    pr = make_problem(H, W, 4, 3, P, seed=2)
    cj, ct = cams(H, W)
    _, k1, _ = params_both(pr, cj, ct, 1, 0.0, 0.1, 2.0, "se3")
    _, k4, _ = params_both(pr, cj, ct, 4, 0.0, 0.1, 2.0, "se3")
    i1 = tse.sfm_error_batch(k1, *_pools_t(pr))[1]
    i4 = tse.sfm_error_batch(k4, *_pools_t(pr))[1]
    assert torch.all(i4 < i1)


# ----------------------------------------------------------------------------
# what surrounds the CUDA kernels: the plan they are handed, the order of
# their sums, the tickets after a failed launch. These tests check the plan
# and the wrapper, not the kernels: those run only on a card, where
# chip_smoke.py holds them against the twins.
# ----------------------------------------------------------------------------

def _block_sum(vals):
    """[THREADS, ...] -> [...]: a warp adds its lanes by the shuffle tree
    (offsets 16, 8, 4, 2, 1), then the block adds its warps in order; fp32."""
    lanes = vals.reshape((tsg.THREADS // 32, 32) + vals.shape[1:]).copy()
    for off in (16, 8, 4, 2, 1):
        lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
    total = np.zeros(vals.shape[1:], np.float32)
    for w in range(tsg.THREADS // 32):
        total = total + lanes[w, 0]
    return total


def _kernel_order_sums(e, valid, plan):
    """(sum e*e, sum valid) per factor [2, P] in csrc/sfm_error.cu's order:
    each thread fmaf-sums its pixels in order and the block sums its
    threads (``_block_sum``) into one partial per strip; the last block
    sums the strips' partials, one a thread, the same way; all in fp32."""
    P, N = e.shape
    ee = e.numpy().astype(np.float32)
    vv = valid.numpy().astype(np.float32)
    strips = np.zeros((tsg.THREADS, 2, P), np.float32)
    for blk in range(plan.nblk):
        begin, end = blk * plan.px_per_blk, min(N, (blk + 1) * plan.px_per_blk)
        acc = np.zeros((tsg.THREADS, 2, P), np.float32)
        for first in range(begin, end, tsg.THREADS):
            n = min(tsg.THREADS, end - first)
            x = np.zeros((tsg.THREADS, P), np.float32)
            v = np.zeros((tsg.THREADS, P), np.float32)
            x[:n], v[:n] = ee[:, first:first + n].T, vv[:, first:first + n].T
            acc[:, 0] = _fma32(x, x, acc[:, 0])
            acc[:, 1] = acc[:, 1] + v
        strips[blk] = _block_sum(acc)
    return _block_sum(strips)


@pytest.mark.parametrize("P", [3, 64])
@pytest.mark.parametrize("name", ["sfm_error_batch", "se3_warp_batch"])
def test_error_kernel_summation_order_within_tolerance(monkeypatch, name, P):
    """The reason for chip_smoke.py's ERR_RES_TOL (1e-4 of the residual,
    inliers equal): the twin's per-pixel terms summed again in fp32 in the
    order of the plan the kernel is handed (one pixel a thread and 12
    strips at P = 3, two pixels and 6 strips at P = 64), against the twin's
    own sums, at 48x64. It checks the plan and the order, not the kernel."""
    H, W = 48, 64
    pr, _, _, _, kt = _problem(H, W, P, seed=6)
    pr["active"][:] = 1
    got = {}
    masked = tse._masked_sums

    def spy(e, valid, active):
        got["e"], got["valid"] = e, valid
        return masked(e, valid, active)

    monkeypatch.setattr(tse, "_masked_sums", spy)
    res, inl = getattr(tse, name)(kt, *_pools_t(pr))[-2:]
    plan = tsg.launch_plan(name, P, H, W)
    ppt = 1 if P == 3 else 2
    assert plan.px_per_blk == 256 * ppt and plan.nblk == 12 // ppt
    mine = _kernel_order_sums(got["e"], got["valid"], plan)
    np.testing.assert_array_equal(mine[1], inl.numpy())
    assert np.all(inl.numpy() > 0)
    rel = np.abs(mine[0] - res.numpy()) / res.numpy()
    assert rel.max() < 1e-4
    assert rel.max() > 0, "the orders should differ in the last bits"


def test_failed_error_launch_drops_its_streams_tickets(monkeypatch):
    """A launch whose library returns an error code raises, counts no
    launch, and throws away its stream's ticket buffer, so that the next
    call on that stream starts from zeros. Without ``active`` the kernel is
    handed a null pointer (every factor active), not a tensor of ones."""
    pr, _, _, _, kt = _problem(24, 32, 3, seed=2)
    seen = []

    class FailingLib:
        def sfm_error_launch(self, *args):
            assert len(args) == 20
            seen.append(args[3].value)
            return 1

        def sfm_error_error_string(self, code):
            return b"invalid argument"

    monkeypatch.setattr(tsg, "_lib", lambda *a: FailingLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=7))
    cpu = torch.device("cpu")
    tsg._TICKETS.clear()
    for name, mode, active in (("sfm_error_batch", 0, T(pr["active"])),
                               ("se3_warp_batch", 1, None)):
        tsg._tickets(cpu, 7, 3)[0] = 1        # what a failed launch may leave
        with pytest.raises(RuntimeError, match="invalid argument"):
            tse._launch(name, kt, *_pools_t(pr), active, mode)
        assert (cpu.index, 7) not in tsg._TICKETS
        assert not tsg._tickets(cpu, 7, 3).any()
    assert seen[0] is not None and seen[1] is None
    assert tse.LAUNCHES == {"sfm_error_batch": 0, "se3_warp_batch": 0}
    tsg._TICKETS.clear()


def test_cpu_tensors_never_launch_the_error_kernels():
    assert tse.LAUNCHES == {"sfm_error_batch": 0, "se3_warp_batch": 0}
    assert jax.devices()[0].platform == "cpu"
