"""Several processes in the port (deepfactors_tpu_torch/parallel/multihost.py,
tools/multihost_demo.py, parallel/dryrun.dryrun_matrix,
BatchedOdometry(group=), make_train_step(group=) and
train_room_decoder --distributed) on gloo ranks on the CPU, against one
process of the port and against the JAX package on conftest's virtual
8-device CPU mesh.

One world of 2 ranks is started once for the module (``world2``): each rank
runs the demo's BA steps on its factor rows, the odometry on its block of
the scenes, one training step on its rows of the batch and 3 steps of
``train``, and writes every result to a file. Sizes are small: the demo's
problem at K 8, CS 4, 48x64, 8 factors; 8 scenes at 32x48 over 2 levels;
the VAE at tests/test_torch_train.py's size (code 4, 2 levels, 24x32,
base_ch 8) with a batch of 4. The
dry-run matrix runs the JAX package's production problem (16 factors at
192x256, CS 32), since that is what ``__graft_entry__.dryrun_multichip``
runs.

Tolerances:
  - BA over ranks against one process 1e-5 (tests/test_torch_parallel.py's
    two-rank test); against JAX 1e-4 (its BA tolerance).
  - Odometry over ranks against one process 1e-6; read: bit-equal (each
    scene's rows of the plain Gram do not depend on the scene count).
    Against JAX test_batched_odometry_matches_jax's 1e-4.
  - Training over 2 ranks of 2 rows against one process of 4: the loss,
    nll, kl and distill relative 1e-5 (read 7.5e-8: the mean of two
    half-batch means against one mean); the gradient norm relative 5e-3
    (read 6.6e-4), each leaf's gradient relative L2 1e-2 (read 2.55e-3)
    and all together 5e-3 (read 1.6e-3): a bf16 convolution's weight and
    bias gradients come out rounded to bf16 (half an ulp is 2^-9 = 1.95e-3
    relative), once over the batch in one process and once over each
    rank's rows in a world; the parameters after the update within 2 lr
    (read 0.47 lr), apart by more than 0.1 lr at no more than 1e-4 of the
    elements (Adam's first step is ~lr x sign(g), so where a gradient
    element is near 0 its sign may flip): read 1.8e-6 (2 of 1133856),
    against 0.167 and 0.170 for a planted fault, a rank stepping on its
    own 2 rows with no reduce. ``train(group=)``'s loss at each of 3
    steps relative 1e-4 (read 0, 0, 1.4e-5: the updates part at bf16
    rounding).
  - Training against JAX's make_train_step with its batch under a 2-device
    NamedSharding: tests/test_torch_train.py's loss 2e-4 and terms 1e-2
    (relative); its Adam step within 2 lr everywhere and apart by more than
    0.1 lr at no more than 3% of the elements (chip_smoke.py's 11a limit:
    the first step moves an element by ~lr x sign(g), so a near-zero
    gradient may flip).
"""
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry import warping as jwp
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.models import train_decoder as jtd
from deepfactors_tpu.ops import dense_sfm as jds
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu.parallel import dist_ba as jdb
from deepfactors_tpu.parallel import multihost as jmh
from deepfactors_tpu.parallel import multi_seq as jmsq
from deepfactors_tpu_torch import train_room_decoder as ttr
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.models import train_decoder as ttd
from deepfactors_tpu_torch.parallel import dist_ba as tdb
from deepfactors_tpu_torch.parallel import dryrun as tdr
from deepfactors_tpu_torch.parallel import multihost as tmh
from deepfactors_tpu_torch.parallel import multi_seq as tmsq
from deepfactors_tpu_torch.tools import multihost_demo as tmd
from test_torch_train import (BC, BETA, CS as TCS, DISTILL_W, H as TH, L,
                              LOSS_TOL, TERM_TOL, W as TW, _jax_vae)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = dict(K=8, CS=4, H=48, W=64, factors=8)
OH, OW, S, LEVELS = 32, 48, 8, 2
B = 4                                   # the training batch: 2 rows a rank
LR = 3e-4
BA_RANKS_TOL, BA_JAX_TOL = 1e-5, 1e-4
ODO_RANKS_TOL, ODO_JAX_TOL = 1e-6, 1e-4
# data-parallel against one process (the readings: the docstring)
DP_TERM_TOL, DP_NORM_TOL, DP_LEAF_TOL, DP_ALL_TOL = 1e-5, 5e-3, 1e-2, 5e-3
DP_FLIP_SHARE = 1e-4
DP_HISTORY_TOL = 1e-4
FLIP_SHARE = 0.03
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="2")

_RANK_SCRIPT = r"""
import argparse
import numpy as np
import torch
from deepfactors_tpu_torch.geometry.camera import PinholeCamera
from deepfactors_tpu_torch.models import train_decoder as td
from deepfactors_tpu_torch.parallel import multihost, multi_seq
from deepfactors_tpu_torch.tools import multihost_demo as md

torch.set_num_threads(2)
ap = argparse.ArgumentParser()
for f in ("--data", "--out", "--coord"):
    ap.add_argument(f)
for f in ("--nproc", "--proc-id"):
    ap.add_argument(f, type=int)
a = ap.parse_args()
multihost.initialize(a.coord, a.nproc, a.proc_id, backend="gloo",
                     device="cpu")
try:
    group = multihost.global_group()
    d = torch.load(a.data, weights_only=False)
    out = {}
    q, t, c, stats = md.run_steps(*d["demo"], "cpu", group)
    out["demo"] = dict(q=q, t=t, c=c, stats=stats)
    cam = PinholeCamera.create(**d["cam"])
    odo = multi_seq.BatchedOdometry(cam, group=group, **d["odo_kw"])
    st = odo.init(d["frames"][0], d["depth"])
    poses, sw = [], []
    for f in d["frames"][1:]:
        st, p, w = odo.process(st, f)
        poses.append(torch.cat([p.q, p.t], 1).numpy())
        sw.append(w.numpy())
    out["odo"] = dict(poses=np.stack(poses), switch=np.stack(sw),
                      own=st.kf_pose_t.shape[0])
    m = td.VAEModel(*d["vae"])
    m.load_state_dict(d["state"])
    opt = td.OptaxAdam(m.parameters(), d["lr"], clip_norm=1.0)
    step = td.make_train_step(m, opt, d["beta"], d["distill_w"], group)
    rows = multihost.rank_rows(d["imgs"].shape[0],
                               *multihost.world_rank(group))
    loss, aux = step(d["imgs"][rows], d["gts"][rows], d["eps"])
    out["train"] = dict(
        loss=float(loss), aux={k: float(v) for k, v in aux.items()},
        grads={n: p.grad.clone() for n, p in m.named_parameters()},
        params={n: p.detach().clone() for n, p in m.named_parameters()})
    cfg = td.NetworkConfig(**d["train_cfg"])
    params, history = td.train(cfg, td.synthetic_depth_dataset(cfg, 4), 3,
                               log_every=1, device="cpu", log=print,
                               group=group)
    out["train_fn"] = dict(history=history, params=params)
    torch.save(out, "%s.rank%d.pt" % (a.out, a.proc_id))
finally:
    multihost.shutdown()
"""


def _jax_eps(key, n):
    return np.stack([np.asarray(jax.random.normal(k, (TCS,)))
                     for k in jax.random.split(key, n)])


def _train_batch():
    cfg = jtd.NetworkConfig(code_size=TCS, pyramid_levels=L, input_width=TW,
                            input_height=TH)
    imgs, dpts = next(jtd.synthetic_depth_dataset(cfg, batch=B, seed=3))
    return imgs, (2.0 / (2.0 + dpts)).astype(np.float32)


def _odo_frames():
    """8 textured scenes moving along x at their own speeds, rendered with
    the JAX package's warp (4 frames; the threshold makes the fast scenes
    switch their keyframe and the slow ones not)."""
    cam = JCam.create(fx=40.0, fy=40.0, u0=OW / 2, v0=OH / 2, width=OW,
                      height=OH)
    ys, xs = np.mgrid[0:OH, 0:OW].astype(np.float32)
    pix = jds._pixel_grid(OH, OW).reshape(-1, 2)
    steps = np.linspace(0.004, 0.03, S).astype(np.float32)

    def render(s, i):
        base = (0.5 + 0.25 * np.sin(xs / (4 + s % 4))
                + 0.2 * np.cos(ys / (5 + s % 3))).astype(np.float32)
        d = np.zeros(6, np.float32)
        d[0] = steps[s] * i
        c = jwp.find_correspondence(
            pix, jnp.full(OH * OW, 2.0), cam,
            jse3.retract(jse3.identity(), jnp.asarray(d)), check_bounds=False)
        return np.asarray(jip.bilinear_sample(jnp.asarray(base), c.pix1)
                          ).reshape(OH, OW)

    return np.stack([np.stack([render(s, i) for s in range(S)])
                     for i in range(4)])


ODO_KW = dict(levels=LEVELS, iters_per_level=(8, 6), kf_dist_threshold=0.05)
TRAIN_CFG = dict(code_size=TCS, pyramid_levels=L, input_width=TW,
                 input_height=TH)
CAM_KW = dict(fx=40.0, fy=40.0, u0=OW / 2, v0=OH / 2, width=OW, height=OH)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every input, the results of one world of 2 gloo ranks (each rank's
    dict), and the port's one-process results."""
    tmp = tmp_path_factory.mktemp("world2")
    model, params = _jax_vae("conv", 2)
    state = ttd.vae_params_from_jax(params)
    imgs, gts = _train_batch()
    key = jax.random.PRNGKey(7)
    eps = _jax_eps(key, B)
    frames = _odo_frames()
    depth = np.full((S, OH, OW), 2.0, np.float32)
    demo = tuple(DEMO[k] for k in ("K", "CS", "H", "W", "factors"))
    data = dict(demo=demo, cam=CAM_KW, odo_kw=ODO_KW, train_cfg=TRAIN_CFG,
                frames=torch.from_numpy(frames), depth=torch.from_numpy(depth),
                vae=(TCS, L, BC, "conv", (TH, TW)), state=state, lr=LR,
                beta=BETA, distill_w=DISTILL_W, imgs=torch.from_numpy(imgs),
                gts=torch.from_numpy(gts), eps=torch.from_numpy(eps))
    path = str(tmp / "data.pt")
    torch.save(data, path)
    outs = tmh.World([sys.executable, "-c", _RANK_SCRIPT, "--data", path,
                      "--out", str(tmp / "out")], 2, env=RANK_ENV).wait(240)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{out}"
    ranks = [torch.load(str(tmp / f"out.rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return dict(data=data, ranks=ranks, model=model, params=params, key=key)


# ---------------------------------------------------------------- multihost

@pytest.mark.parametrize("world,n", [(1, 8), (2, 8), (4, 16), (3, 9),
                                     (2, 7)])
def test_host_factor_slice_matches_jax(monkeypatch, world, n):
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(tmh, "process_count", lambda: world)
        monkeypatch.setattr(tmh, "process_index", lambda: rank)
        if n % world:
            for f in (jmh.host_factor_slice, tmh.host_factor_slice):
                with pytest.raises(AssertionError, match="must divide"):
                    f(n)
        else:
            assert tmh.host_factor_slice(n) == jmh.host_factor_slice(n)


def test_initialize_alone_is_a_no_op(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    tmh.initialize(device="cpu")
    try:
        tmh.initialize(device="cpu")                       # idempotent
        assert not torch.distributed.is_initialized()
        assert tmh.process_count() == 1 and tmh.process_index() == 0
        assert tmh.global_group() is None
        assert tmh.local_device() == torch.device("cpu")
        assert tmh.host_factor_slice(6) == slice(0, 6)
    finally:
        tmh.shutdown()
    with pytest.raises(RuntimeError, match="has not run"):
        tmh.local_device()


def test_initialize_refuses_what_it_cannot_run(monkeypatch):
    """No card: device cuda stops; NCCL with more ranks than cards raises
    and names gloo (never a silent fallback); a half-given rendezvous."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmh.initialize(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for v in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError, match=r"2 ranks on this host, 1 card.*"
                                           r"backend='gloo'"):
        tmh.initialize("file:///nonexistent/rdzv", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match="nccl backend needs"):
        tmh.initialize("file:///nonexistent/rdzv", 1, 0, backend="nccl",
                       device="cpu")
    with pytest.raises(ValueError, match="together"):
        tmh.initialize("localhost:1", 2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("how", ["local_device_ids", "local_env"])
def test_initialize_counts_only_this_hosts_ranks(monkeypatch, how):
    """Two hosts of one card each, NCCL, an explicit rendezvous: a rank
    that names its card (``local_device_ids``) or has LOCAL_RANK /
    LOCAL_WORLD_SIZE is checked against the ranks on its own host, so a
    world larger than the card count joins on that card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(tmh, "_DEVICE", None)
    calls = []
    monkeypatch.setattr(tmh.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for v in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    kw = {}
    if how == "local_device_ids":
        kw["local_device_ids"] = [0]
    else:
        monkeypatch.setenv("LOCAL_RANK", "0")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    tmh.initialize("host1:29400", 2, 1, backend="nccl", **kw)
    (args, k), = calls
    assert args == ("nccl",)
    assert (k["init_method"], k["world_size"], k["rank"]) == (
        "tcp://host1:29400", 2, 1)
    assert k["device_id"] == torch.device("cuda", 0) == tmh.local_device()


def test_host_local_to_global_keeps_the_rows():
    rows = tmd.factor_rows(4, 3, 8, 10, 8, slice(2, 6))
    fd = tmh.host_local_to_global(rows, "cpu")
    assert isinstance(fd, tdb.ShardedFactorData)
    assert all(isinstance(x, torch.Tensor) for x in fd)
    assert fd.jac0.shape == (4, 8, 10, 3)
    np.testing.assert_array_equal(fd.src.numpy(), [2, 3, 0, 1])
    np.testing.assert_array_equal(fd.jac0.numpy(), rows.jac0)


# --------------------------------------------------------------------- demo

def _jax_demo(K, CS, H, W, factors, n_devices):
    """The JAX demo's worker, in this process, on an n-device mesh: the
    whole factor table sharded over the mesh, 3 steps."""
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("factors",))
    cam = JCam.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2, width=W,
                      height=H)
    params = jds.SfmParams(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0,
                           valid_border=1)
    rows = tmd.factor_rows(K, CS, H, W, factors, slice(0, factors))
    fd = jmh.host_local_to_global(mesh, "factors",
                                  jdb.ShardedFactorData(*rows))
    step = jdb.make_ba_step(mesh, "factors", K, CS, cam, params)
    q = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (K, 1))
    t = jnp.zeros((K, 3), jnp.float32)
    c = jnp.zeros((K, CS), jnp.float32)
    for _ in range(tmd.STEPS):
        q, t, c, stats = step(q, t, c, fd, jnp.ones((K,), bool))
    return [np.asarray(x) for x in (q, t, c, stats)]


def test_demo_ranks_match_one_process_and_jax(world2):
    ranks = [r["demo"] for r in world2["ranks"]]
    for k in ("q", "t", "c", "stats"):
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])
    one = tmd.run_steps(*world2["data"]["demo"], "cpu")
    jx = _jax_demo(**DEMO, n_devices=4)
    for i, k in enumerate(("q", "t", "c")):
        np.testing.assert_allclose(ranks[0][k], one[i], atol=BA_RANKS_TOL)
        np.testing.assert_allclose(ranks[0][k], jx[i], atol=BA_JAX_TOL)
    assert np.abs(ranks[0]["t"]).max() > 1e-3                    # it moved
    np.testing.assert_allclose(ranks[0]["stats"], jx[3], rtol=1e-3)
    assert tmd.digest(ranks[0]["t"], ranks[0]["stats"]) == tmd.digest(
        ranks[1]["t"], ranks[1]["stats"])


def test_multihost_demo_launcher_passes():
    """``python -m deepfactors_tpu_torch.tools.multihost_demo --device cpu
    --backend gloo`` at a small size: every rank's digest agrees, rc 0."""
    argv = ["--device", "cpu", "--backend", "gloo", "--timeout", "240"]
    argv += [x for k, v in DEMO.items() for x in (f"--{k}", str(v))]
    env = dict(RANK_ENV, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m",
                        "deepfactors_tpu_torch.tools.multihost_demo"] + argv,
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MULTIHOST DEMO: PASS" in r.stdout
    digests = [ln for ln in r.stdout.splitlines() if ln.startswith("DIGEST")]
    assert len(digests) == 2 and digests[0] == digests[1]
    one = tmd.run_steps(*(DEMO[k] for k in ("K", "CS", "H", "W", "factors")),
                        "cpu")
    got = [float(x) for x in digests[0].split()[1:]]
    assert abs(got[0] - float(np.abs(one[1]).sum())) <= BA_RANKS_TOL
    assert got[1] == float(one[3][1])


# ------------------------------------------------------------------- dryrun

def test_dryrun_matrix_matches_jax(monkeypatch):
    """Worlds 1, 2 and 4 of the port (a process a rank) against
    ``__graft_entry__.dryrun_multichip`` on meshes of 1, 2 and 4 devices."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    prev = jds.use_pallas_warp()
    jds.use_pallas_warp(False)
    try:
        devs, res = tdr.dryrun_matrix((1, 2, 4), backend="gloo",
                                      device="cpu", timeout_s=240)
        for n in (1, 2, 4):
            qj, tj, cj = g.dryrun_multichip(n)
            np.testing.assert_allclose(res[n]["q"], qj, atol=BA_JAX_TOL)
            np.testing.assert_allclose(res[n]["t"], tj, atol=BA_JAX_TOL)
            np.testing.assert_allclose(res[n]["c"], cj, atol=BA_JAX_TOL)
    finally:
        jds.use_pallas_warp(prev)
    assert set(devs) == {1, 2, 4} and max(devs.values()) <= 1e-4
    assert np.abs(res[1]["t"]).max() > 1e-4
    # CPU tensors run the kernels' plain twins: every count of every rank 0
    for n, r in res.items():
        assert len(r["launches"]) == n
        assert all(set(c) >= {"dense_warp_batch", "se3_gram_batch"}
                   and not any(c.values()) for c in r["launches"])


# ----------------------------------------------------------------- odometry

def test_batched_odometry_ranks_match_one_process_and_jax(world2):
    d = world2["data"]
    ranks = [r["odo"] for r in world2["ranks"]]
    assert [r["own"] for r in ranks] == [S // 2] * 2   # the state per rank
    np.testing.assert_array_equal(ranks[1]["poses"], ranks[0]["poses"])
    np.testing.assert_array_equal(ranks[1]["switch"], ranks[0]["switch"])
    ot = tmsq.BatchedOdometry(TCam.create(**CAM_KW), **ODO_KW)
    st = ot.init(d["frames"][0], d["depth"])
    oj = jmsq.BatchedOdometry(
        JCam.create(**CAM_KW), **ODO_KW,
        mesh=Mesh(np.array(jax.devices()[:8]), ("dp",)), axis="dp")
    sj = oj.init(jnp.asarray(d["frames"][0].numpy()),
                 jnp.asarray(d["depth"].numpy()))
    for i in range(1, 4):
        st, pt, wt = ot.process(st, d["frames"][i])
        sj, pj, wj = oj.process(sj, jnp.asarray(d["frames"][i].numpy()))
        one = torch.cat([pt.q, pt.t], 1).numpy()
        got = ranks[0]["poses"][i - 1]
        assert np.abs(got - one).max() <= ODO_RANKS_TOL
        np.testing.assert_array_equal(ranks[0]["switch"][i - 1], wt.numpy())
        np.testing.assert_array_equal(ranks[0]["switch"][i - 1],
                                      np.asarray(wj))
        np.testing.assert_allclose(got[:, :4], np.asarray(pj.q),
                                   atol=ODO_JAX_TOL)
        np.testing.assert_allclose(got[:, 4:], np.asarray(pj.t),
                                   atol=ODO_JAX_TOL)
    seen = ranks[0]["switch"]
    assert seen[:, -1].any() and not seen[:, 0].any()


def test_batched_odometry_needs_a_divisible_scene_count():
    ot = tmsq.BatchedOdometry(TCam.create(**CAM_KW), **ODO_KW)
    ot.world, ot.rank = 3, 0
    with pytest.raises(AssertionError, match="do not split"):
        ot.init(torch.zeros(4, OH, OW), torch.ones(4, OH, OW))


# ----------------------------------------------------------------- training

def _one_process_step(world2):
    d = world2["data"]
    m = ttd.VAEModel(*d["vae"])
    m.load_state_dict(d["state"])
    opt = ttd.OptaxAdam(m.parameters(), LR, clip_norm=1.0)
    step = ttd.make_train_step(m, opt, BETA, DISTILL_W)
    loss, aux = step(d["imgs"], d["gts"], d["eps"])
    return m, float(loss), {k: float(v) for k, v in aux.items()}


def test_train_step_ranks_match_one_process(world2):
    ranks = [r["train"] for r in world2["ranks"]]
    for k in ("grads", "params"):
        for n, v in ranks[0][k].items():
            assert torch.equal(v, ranks[1][k][n]), (k, n)
    assert ranks[0]["aux"] == ranks[1]["aux"]
    m, loss, aux = _one_process_step(world2)
    got = ranks[0]
    assert abs(got["loss"] - loss) <= DP_TERM_TOL * abs(loss)
    for k in ("nll", "kl", "distill"):
        assert abs(got["aux"][k] - aux[k]) <= DP_TERM_TOL * abs(aux[k]), k
    assert abs(got["aux"]["grad_norm"] - aux["grad_norm"]) <= (
        DP_NORM_TOL * aux["grad_norm"])
    num = den = 0.0
    far = total = 0
    for n, p in m.named_parameters():
        e, d = float((got["grads"][n] - p.grad).norm()), float(p.grad.norm())
        assert e <= DP_LEAF_TOL * d, (n, e / d)
        num, den = num + e * e, den + d * d
        diff = (got["params"][n] - p.detach()).abs()
        assert float(diff.max()) <= 2.0 * LR * 1.001, n
        far += int((diff > 0.1 * LR).sum())
        total += diff.numel()
    assert (num / den) ** 0.5 <= DP_ALL_TOL
    assert far <= DP_FLIP_SHARE * total, far / total


def test_train_function_ranks_match_one_process(world2):
    """``train(..., group=)``: 3 steps of clip + adam on the synthetic
    dataset's batches of 4, 2 rows a rank, against one process."""
    ranks = [r["train_fn"] for r in world2["ranks"]]
    cfg = ttd.NetworkConfig(**TRAIN_CFG)
    params, history = ttd.train(cfg, ttd.synthetic_depth_dataset(cfg, 4), 3,
                                log_every=1, device="cpu",
                                log=lambda *a: None)
    assert ranks[0]["history"] == ranks[1]["history"]
    assert len(history) == 3
    np.testing.assert_allclose(ranks[0]["history"], history,
                               rtol=DP_HISTORY_TOL)
    a, b = (jax.tree_util.tree_leaves(r["params"]) for r in ranks)
    assert len(a) == len(jax.tree_util.tree_leaves(params)) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_train_step_ranks_match_jax_sharded_batch(world2):
    """JAX's make_train_step with its batch under NamedSharding(P("dp"))
    over 2 devices: the loss and its terms, and the parameters after the
    update (the gradients of the unsharded step are held to JAX's in
    tests/test_torch_train.py)."""
    d, model, params = world2["data"], world2["model"], world2["params"]
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    shard = NamedSharding(mesh, PartitionSpec("dp"))
    imgs = jax.device_put(jnp.asarray(d["imgs"].numpy()), shard)
    gts = jax.device_put(jnp.asarray(d["gts"].numpy()), shard)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    state = jtd.TrainState(params, tx.init(params), jnp.asarray(0))
    new, lj, auxj = jtd.make_train_step(model, tx, BETA, DISTILL_W)(
        state, imgs, gts, world2["key"])
    got = world2["ranks"][0]["train"]
    assert abs(got["loss"] - float(lj)) <= LOSS_TOL * abs(float(lj))
    assert abs(got["aux"]["nll"] - float(auxj["nll"])) <= LOSS_TOL * abs(
        float(auxj["nll"]))
    for k in ("kl", "distill"):
        assert abs(got["aux"][k] - float(auxj[k])) <= TERM_TOL * abs(
            float(auxj[k])), k
    pj = ttd.vae_params_from_jax(jax.tree.map(np.asarray, new.params))
    far = total = 0
    for n, p in pj.items():
        diff = (got["params"][n] - p).abs()
        assert float(diff.max()) <= 2.0 * LR * 1.001 + 1e-7, n
        far += int((diff > 0.1 * LR).sum())
        total += diff.numel()
    assert far <= FLIP_SHARE * total, far / total


def test_train_entry_distributed_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m ...train_room_decoder --distributed
    --device cpu``, 3 steps at batch 2: the ranks agree with one process
    step for step, only rank 0 writes."""
    argv = ["--steps", "3", "--batch", "2", "--rooms", "1", "--val-rooms",
            "1", "--poses-per-room", "2", "--randomize", "--pred-head",
            "conv", "--log-every", "1", "--device", "cpu"]
    out = str(tmp_path / "two" / "t")
    env = dict(RANK_ENV, PYTHONPATH=ROOT)
    # torchrun in a session of its own: on a timeout its ranks go with it
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "deepfactors_tpu_torch.train_room_decoder", "--distributed",
         "--out", out] + argv, cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, stdout + stderr
    assert stdout.count("parameters bit-identical over 2 ranks") == 2
    assert stdout.count("saved ") == 1
    assert os.path.exists(out + ".pkl") and os.path.exists(out + ".json")
    one = ttr.main(argv + ["--out", str(tmp_path / "one" / "t")],
                   log=lambda *a: None)
    logged = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
    assert len(logged) == 6
    for i, (_, loss) in enumerate(one["logged"]):
        got = [float(ln.split("loss=")[1].split()[0]) for ln in logged
               if ln.startswith(f"step {i}:")]
        assert len(got) == 2 and all(
            abs(x - loss) <= 1e-4 * abs(loss) + 1e-4 for x in got), (got, loss)
