"""deepfactors_tpu_torch.parallel against the JAX package's parallel/ on a
one-device mesh: the factor-sharded BA step and the large-map BA loop on the
map of tests/test_parallel.py, the shards' systems against the unsharded
one, a two-process gloo run against one process, the mapper-to-BA bridge
against the port's own mapper, lockstep multi-scene odometry, and the
production-size dry run against ``__graft_entry__.dryrun_multichip(1)``.
Inputs are numpy arrays made once (by the JAX test's own ``make_map`` where
it has one) and handed to both packages.

Tolerances: poses and codes after BA steps 1e-4 absolute (fp32 systems
summed in another order, solved by another Cholesky); sharded vs unsharded
systems 1e-5 of the largest entry; tracked poses 1e-4."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_parallel import CS, H, K, W, make_map

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry import warping as jwp
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.ops import dense_sfm as jds
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu.parallel import dist_ba as jdb
from deepfactors_tpu.parallel import large_map as jlm
from deepfactors_tpu.parallel import multi_seq as jmsq
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping.mapper import Mapper as TMapper
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.ops import dense_sfm as tds
from deepfactors_tpu_torch.ops.kernels import dense_warp as tdw
from deepfactors_tpu_torch.ops.kernels import sfm_gram as tsg
from deepfactors_tpu_torch.parallel import dist_ba as tdb
from deepfactors_tpu_torch.parallel import dryrun as tdr
from deepfactors_tpu_torch.parallel import large_map as tlm
from deepfactors_tpu_torch.parallel import multi_seq as tmsq

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
KW = dict(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0, valid_border=1)
LINKS = [(i, i + 1) for i in range(K - 1)] + [(0, K - 1)]
T = lambda a: torch.from_numpy(np.array(a))


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("factors",))


@pytest.fixture(scope="module")
def xla_warp():
    """The JAX package on its XLA sampling path (its default on a CPU),
    whatever an earlier test left the switch at."""
    prev = jds.use_pallas_warp()
    jds.use_pallas_warp(False)
    yield
    jds.use_pallas_warp(prev)


@pytest.fixture(scope="module")
def the_map(xla_warp):
    """tests/test_parallel.make_map with poses perturbed from a seed, as JAX
    arrays and as torch tensors of the same numbers."""
    cam_j, images, grads, prx0, jac, stdev, poses_true = make_map()
    pert = np.concatenate([np.zeros((1, 6)), np.random.RandomState(1).uniform(
        -0.01, 0.01, (K - 1, 6))]).astype(np.float32)
    poses0 = jax.vmap(jse3.retract)(poses_true, jnp.asarray(pert))
    cam_t = TCam.create(fx=40.0, fy=40.0, u0=W / 2, v0=H / 2, width=W, height=H)
    jx = dict(cam=cam_j, maps=(images, prx0, jac, stdev, grads), poses=poses0,
              codes=jnp.zeros((K, CS)))
    tc = dict(cam=cam_t, maps=tuple(T(a) for a in (images, prx0, jac, stdev,
                                                   grads)),
              poses=TSE3(T(poses0.q), T(poses0.t)), codes=torch.zeros(K, CS))
    return jx, tc, poses_true


def _problems(the_map):
    jx, tc, _ = the_map
    pj = jlm.build_problem(_mesh1(), "factors", *jx["maps"], jx["poses"],
                           jx["codes"], LINKS)
    pt = tlm.build_problem(*tc["maps"], tc["poses"], tc["codes"], LINKS)
    return pj, pt


def test_ba_step_matches_jax_for_two_steps(the_map):
    jx, tc, _ = the_map
    pj, pt = _problems(the_map)
    np.testing.assert_array_equal(pt.fd.src.numpy(), np.asarray(pj.fd.src))
    np.testing.assert_array_equal(pt.fd.dst.numpy(), np.asarray(pj.fd.dst))
    step_j = jdb.make_ba_step(_mesh1(), "factors", K, CS, jx["cam"],
                              jds.SfmParams(**KW), pose_prior=0.05)
    step_t = tdb.make_ba_step(K, CS, tc["cam"], tds.SfmParams(**KW),
                              pose_prior=0.05)
    sj = (pj.pose_q, pj.pose_t, pj.codes)
    st = (pt.pose_q, pt.pose_t, pt.codes)
    for _ in range(2):
        *sj, stats_j = step_j(*sj, pj.fd, pj.active)
        *st, stats_t = step_t(*st, pt.fd, pt.active)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
        np.testing.assert_allclose(stats_t.numpy(), np.asarray(stats_j),
                                   rtol=1e-3)
    assert np.abs(st[1].numpy() - pt.pose_t.numpy()).max() > 1e-3   # it moved


def test_large_map_ba_matches_jax_and_converges(the_map):
    jx, tc, poses_true = the_map
    pj, pt = _problems(the_map)
    ba_j = jlm.LargeMapBA(_mesh1(), "factors", K, CS, jx["cam"],
                          jds.SfmParams(**KW), pose_prior=0.05)
    ba_t = tlm.LargeMapBA(K, CS, tc["cam"], tds.SfmParams(**KW),
                          pose_prior=0.05)
    poses_j, codes_j, _ = ba_j.run(pj, iters=8)
    poses_t, codes_t, hist = ba_t.run(pt, iters=8)
    assert len(hist) == 8 and all(h.shape == (2,) for h in hist)
    np.testing.assert_allclose(poses_t.q.numpy(), np.asarray(poses_j.q), atol=ATOL)
    np.testing.assert_allclose(poses_t.t.numpy(), np.asarray(poses_j.t), atol=ATOL)
    np.testing.assert_allclose(codes_t.numpy(), np.asarray(codes_j), atol=ATOL)
    true = TSE3(T(poses_true.q), T(poses_true.t))
    err = lambda p: float(tse3.local(true, p)[:, :3].norm(dim=-1).max())
    assert err(poses_t) < 0.4 * err(tc["poses"])


@pytest.mark.parametrize("world", [2, 4])
def test_shard_systems_sum_to_the_unsharded_system(the_map, world):
    """11 factors (one row dropped) do not divide by 2 or 4: the shards are
    padded with inactive rows, and their (H, b, stats) sum to the system of
    all factors at once."""
    _, tc, _ = the_map
    pt = tlm.build_problem(*tc["maps"], tc["poses"], tc["codes"], LINKS)
    fd = tdb.ShardedFactorData(*(x[:-1] for x in pt.fd))
    n = fd.src.shape[0]
    args = (pt.pose_q, pt.pose_t, pt.codes)
    tail = (K, CS, tc["cam"], tds.SfmParams(**KW))
    H1, b1, s1 = tdb.local_system(*args, fd, *tail)
    shards = [tdb.shard_factors(fd, world, r) for r in range(world)]
    per = -(-n // world)
    assert all(s.src.shape[0] == per and s.jac0.shape == (per, H, W, CS)
               for s in shards)
    assert sum(int(s.active.sum()) for s in shards) == n
    assert not bool(shards[-1].active[-1])
    parts = [tdb.local_system(*args, s, *tail) for s in shards]
    Hn, bn, sn = (sum(p[i] for p in parts) for i in range(3))
    assert torch.isfinite(Hn).all() and torch.isfinite(sn).all()
    np.testing.assert_allclose(Hn.numpy(), H1.numpy(),
                               atol=1e-5 * float(H1.abs().max()))
    np.testing.assert_allclose(bn.numpy(), b1.numpy(),
                               atol=1e-5 * float(b1.abs().max()))
    np.testing.assert_allclose(sn.numpy(), s1.numpy(), rtol=1e-5)
    # build_problem shards the same way without gathering the other ranks
    for r in range(world):
        pr = tlm.build_problem(*tc["maps"], tc["poses"], tc["codes"],
                               LINKS, world, r)
        whole = tdb.shard_factors(pt.fd, world, r)
        on = whole.active
        np.testing.assert_array_equal(pr.fd.active.numpy(), on.numpy())
        np.testing.assert_array_equal(pr.fd.src[on].numpy(), whole.src[on].numpy())
        np.testing.assert_array_equal(pr.fd.img1[on].numpy(), whole.img1[on].numpy())


_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.geometry.se3 import SE3
from deepfactors_tpu_torch.ops import dense_sfm as ds
from deepfactors_tpu_torch.parallel import large_map

torch.set_num_threads(1)
root, path, rendezvous, world, rank = sys.argv[1:6]
world, rank = int(world), int(rank)
dist.init_process_group("gloo", init_method="file://" + rendezvous,
                        world_size=world, rank=rank)
d = np.load(path)
t = lambda k: torch.from_numpy(d[k])
K, CS = d["codes"].shape
H, W = d["images"].shape[1:]
cam = PinholeCamera.create(fx=40.0, fy=40.0, u0=W / 2, v0=H / 2, width=W,
                           height=H)
links = [tuple(l) for l in d["links"]]
prob = large_map.build_problem(t("images"), t("prx0"), t("jac"), t("stdev"),
                               t("grads"), SE3(t("q"), t("t")), t("codes"),
                               links, world, rank)
params = ds.SfmParams(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0,
                      valid_border=1)
ba = large_map.LargeMapBA(K, CS, cam, params, pose_prior=0.05,
                          group=dist.group.WORLD)
poses, codes, _ = ba.run(prob, iters=2)
np.savez(path + ".out%d.npz" % rank, q=poses.q.numpy(), t=poses.t.numpy(),
         c=codes.numpy())
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_two_gloo_ranks_match_one_process(the_map, tmp_path, world):
    """Two (or four) processes, each with its shard of the factors,
    all_reduce the system over a gloo group and reach the estimate of one
    process (four ranks: 10 factors padded to 12, 3 a rank)."""
    _, tc, _ = the_map
    links = LINKS[:-1]                    # 10 factors
    pt = tlm.build_problem(*tc["maps"], tc["poses"], tc["codes"], links)
    ba = tlm.LargeMapBA(K, CS, tc["cam"], tds.SfmParams(**KW), pose_prior=0.05)
    poses, codes, _ = ba.run(pt, iters=2)
    path = str(tmp_path / "map.npz")
    images, prx0, jac, stdev, grads = (x.numpy() for x in tc["maps"])
    np.savez(path, images=images, prx0=prx0, jac=jac, stdev=stdev, grads=grads,
             q=tc["poses"].q.numpy(), t=tc["poses"].t.numpy(),
             codes=tc["codes"].numpy(), links=np.array(links))
    rendezvous = str(tmp_path / "rendezvous")   # a file store, fresh per test
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, ROOT, path,
                               rendezvous, str(world), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=150)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in range(world):
        out = np.load(path + ".out%d.npz" % r)
        np.testing.assert_allclose(out["t"], poses.t.numpy(), atol=1e-5)
        np.testing.assert_allclose(out["q"], poses.q.numpy(), atol=1e-5)
        np.testing.assert_allclose(out["c"], codes.numpy(), atol=1e-5)


def test_mapper_state_bridge_matches_mapper_ba():
    """factors_from_map_state: a live mapper window handed to the BA step
    optimises to the estimate of the mapper's own window BA (same factors,
    priors, damping and loss), as tests/test_parallel.py holds for the JAX
    package. The mapper linearises with the fused ``sfm_gram_batch`` in
    sampled mode, the BA step with the unfused ``sfm_step_batch``."""
    Kc = 3
    cam = TCam.create(fx=40.0, fy=40.0, u0=W / 2, v0=H / 2, width=W, height=H)
    cfg = TMC(max_keyframes=Kc, max_frames=1, max_factors=8, code_size=CS,
              height=H, width=W, pyramid_levels=1, pho_iters=(4,),
              grad_mode="sampled", fine_loss="huber", relin_threshold=0.0,
              use_schur=False, use_reprojection=False)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = lambda k: (0.5 + 0.3 * np.sin(xs / 5 + 0.3 * k)
                     * np.cos(ys / 4 + 0.2 * k)).astype(np.float32)
    m = TMapper(cfg, cam, decoder=None, device="cpu")
    for k in range(Kc):
        m.add_keyframe_to_map(img(k), tse3.identity(device="cpu"))
    m._add_photo_pair(0, 1)
    m._add_photo_pair(1, 2)
    m.sched.bookkeeping()
    pool = m.pool
    act = pool.active & ~pool.dst_is_frame
    assert act.sum() == 4

    fd = tdb.factors_from_map_state(m.state, pool.src, pool.dst, act, level=0)
    assert fd.jac0.shape == (len(act), H, W, CS)
    params = tds.SfmParams(huber_delta=cfg.huber_delta, avg_dpt=cfg.avg_dpt,
                           min_dpt=cfg.min_dpt, valid_border=cfg.valid_border)
    step = tdb.make_ba_step(Kc, CS, cam, params, code_prior=cfg.code_prior,
                            pose_prior=cfg.pose_prior, lam=cfg.lm_lambda)
    q, t, c = m.state.pose.q.clone(), m.state.pose.t.clone(), m.state.code.clone()
    for _ in range(3):
        q, t, c, _ = step(q, t, c, fd, m.state.active)

    iters, _ = m._run(m._compact_pool(), (0,), 3, False)
    assert iters == 3
    assert float(t.abs().max()) > 1e-3                       # it moved
    np.testing.assert_allclose(t.numpy(), m.state.pose.t.numpy(), atol=2e-4)
    np.testing.assert_allclose(q.numpy(), m.state.pose.q.numpy(), atol=2e-4)
    np.testing.assert_allclose(c.numpy(), m.state.code.numpy(), atol=2e-4)


def test_batched_odometry_matches_jax(xla_warp):
    """3 scenes, 3 frames, 2 levels; the threshold is set so that the
    fastest scene switches its keyframe and the others do not."""
    S = 3
    kw = dict(fx=40.0, fy=40.0, u0=W / 2, v0=H / 2, width=W, height=H)
    cam_j, cam_t = JCam.create(**kw), TCam.create(**kw)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    bases = [(0.5 + 0.25 * np.sin(xs / (4 + s)) + 0.2 * np.cos(ys / (5 + s % 2))
              ).astype(np.float32) for s in range(S)]
    steps = np.array([0.005, 0.012, 0.03], np.float32)
    pix = jds._pixel_grid(H, W).reshape(-1, 2)

    def render(s, i):
        d = np.zeros(6, np.float32)
        d[0] = steps[s] * i
        c = jwp.find_correspondence(pix, jnp.full(H * W, 2.0), cam_j,
                                    jse3.retract(jse3.identity(), jnp.asarray(d)),
                                    check_bounds=False)
        return np.asarray(jip.bilinear_sample(jnp.asarray(bases[s]), c.pix1)
                          ).reshape(H, W)

    frames = [np.stack([render(s, i) for s in range(S)]) for i in range(4)]
    depth = np.full((S, H, W), 2.0, np.float32)
    okw = dict(levels=2, iters_per_level=(8, 6), kf_dist_threshold=0.05)
    oj = jmsq.BatchedOdometry(cam_j, **okw)
    ot = tmsq.BatchedOdometry(cam_t, **okw)
    sj = oj.init(jnp.asarray(frames[0]), jnp.asarray(depth))
    st = ot.init(T(frames[0]), T(depth))
    seen = []
    for i in (1, 2, 3):
        sj, pj, wj = oj.process(sj, jnp.asarray(frames[i]))
        st, pt, wt = ot.process(st, T(frames[i]))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_allclose(pt.q.numpy(), np.asarray(pj.q), atol=ATOL)
        np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=ATOL)
        for a, b in zip(st, sj):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=ATOL)
        seen.append(wt.numpy())
    seen = np.stack(seen)
    assert seen[:, 2].any() and not seen[:, 0].any()
    assert abs(abs(float(pt.t[0, 0])) - 3 * steps[0]) < 0.005


def test_dryrun_single_matches_jax_dryrun_multichip(xla_warp):
    """The 192x256, CS 32, 16-factor step of both packages."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    qj, tj, cj = g.dryrun_multichip(1)
    qt, tt, ct = tdr.dryrun_single(device="cpu")
    assert qt.shape == (8, 4) and tt.shape == (8, 3) and ct.shape == (8, 32)
    assert np.abs(tt).max() > 1e-4
    np.testing.assert_allclose(qt, qj, atol=ATOL)
    np.testing.assert_allclose(tt, tj, atol=ATOL)
    np.testing.assert_allclose(ct, cj, atol=ATOL)


def test_cpu_tensors_never_launch_a_kernel():
    assert tdw.LAUNCHES == {"dense_warp_batch": 0, "bilinear_warp_planes": 0}
    assert tsg.LAUNCHES["se3_gram_batch"] == 0
