"""A short facade pair in the reference's refinement configuration: both
packages' ``DeepFactors`` built by their own ``config.build_system_config``
from ``data/flags/alg_refine.flags`` (reprojection and geometric factors
and loop closure on, pho_iters 15,15,30, LASTN with 4 back-connections, the
dense solve), with command-line overrides that fit it to the test's size
(48x64, 2 levels, code size 4) and to the sequence's pacing
(``tracking_dist_threshold`` 5.0: at the flags' 2.0, equal to the keyframe
distance, a frame that crosses 2.0 is lost before it can become a
keyframe, in both packages). The geometric pool is sized by the rep pool's
worst-case rule (``max_keyframes * max_back_connections + 16``), as
``chip_smoke.py`` phase 9 sizes it.

The sequence is the textured plane of tests/test_torch_mapper_rep.py
(4 px a frame, 12 frames), the decoder the small random-init one (base_ch
8, CS 4), the vocabulary the shipped one; the port's mapper replays the JAX
mapper's key chain for its RANSAC hypotheses and its geometric points
(``JaxKeyChain``).

What must agree: keyframe and one-way-frame events frame by frame, the
frame accounting (frames processed, lost, tracked timestamps), the loop
counters, the live geo factors (slots, keyframes and points); the poses
within the tolerances of tests/test_torch_system.py (3e-2 m, 1e-2) and the
rigid ATE within 1e-2 m."""
import os

import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params
from test_torch_mapper_rep import JaxKeyChain, textured_strip

from deepfactors_tpu import config as jcfg
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.loop.vocabulary import default_vocabulary as jvoc
from deepfactors_tpu.models.decoder import Decoder as JDec
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu.system import DeepFactors as JDF
from deepfactors_tpu.utils import tum_io as jtum
from deepfactors_tpu_torch import config as tcfg
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.loop.vocabulary import default_vocabulary as tvoc
from deepfactors_tpu_torch.models.decoder import Decoder as TDec
from deepfactors_tpu_torch.models.decoder import NetworkConfig as TNC
from deepfactors_tpu_torch.system import DeepFactors as TDF
from deepfactors_tpu_torch.utils import tum_io as ttum

torch.set_num_threads(2)
H, W, N, STEP, FX, DEPTH = 48, 64, 12, 4, 55.0, 2.0
POSE_T_TOL, POSE_Q_TOL, ATE_TOL = 3e-2, 1e-2, 1e-2
FLAGS = os.path.join(os.path.dirname(__file__), "..", "data", "flags",
                     "alg_refine.flags")
ARGV = [f"--flagfile={FLAGS}", "--code_size=4", "--pyramid_levels=2",
        "--tracking_dist_threshold=5.0"]


def refine_config(cfg_mod):
    c = cfg_mod.build_system_config(cfg_mod.parse_args(list(ARGV)), H, W)
    m = c.mapper
    return c._replace(mapper=m._replace(
        max_geo_factors=m.max_keyframes * m.max_back_connections + 16))


def _run(df, frames, poses, tum):
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    df.trajectory = [(0.0, df.pose_wc)]
    kf, fr = [], []
    for i in range(3, N):
        n_kf = df.mapper._next_kid
        n_fr = int(np.array(df.mapper.frames.next_id))
        df.process_frame(float(i), frames[i])
        kf.append(df.mapper._next_kid > n_kf)
        fr.append(int(np.array(df.mapper.frames.next_id)) > n_fr)
    g = df.mapper.geo_pool
    live = np.nonzero(g.active)[0]
    gt = [(ts, poses[int(ts)]) for ts, _ in df.trajectory]
    return dict(kf=kf, fr=fr, n_frames=df.n_frames, lost=df.n_lost_frames,
                ts=[ts for ts, _ in df.trajectory],
                loops=(df.n_local_links, df.n_live_global_loops,
                       df.n_archived_loops, df.n_relocalizations),
                geo=[(int(i), int(g.src[i]), int(g.dst[i])) for i in live],
                geo_points=g.points[live].copy(),
                q=np.stack([np.array(p.q) for _, p in df.trajectory]),
                t=np.stack([np.array(p.t) for _, p in df.trajectory]),
                ate=tum.ate_rmse(df.trajectory, gt))


@pytest.fixture(scope="module")
def runs():
    kw = dict(fx=FX, fy=FX, u0=W / 2, v0=H / 2, width=W, height=H)
    frames = textured_strip(N, step=STEP)
    poses = [JSE3(np.array([1.0, 0, 0, 0], np.float32),
                  np.array([STEP * i * DEPTH / FX, 0, 0], np.float32))
             for i in range(N)]
    ncfg = dict(code_size=4, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    jdf = JDF(refine_config(jcfg), JCam.create(**kw),
              decoder=JDec(JNC(**ncfg), params=params), vocabulary=jvoc())
    tdf = TDF(refine_config(tcfg), TCam.create(**kw),
              decoder=TDec(TNC(**ncfg), params=params, device="cpu"),
              vocabulary=tvoc(device="cpu"), device="cpu")
    chain = JaxKeyChain()
    tdf.mapper.ransac_draw = chain
    tdf.mapper.geo_draw = chain.geo
    return dict(jax=_run(jdf, frames, poses, jtum),
                torch=_run(tdf, frames, poses, ttum),
                cfg=tdf.cfg, geo_stats=dict(tdf.mapper.geo_stats))


def test_refine_config_is_the_flags(runs):
    c = runs["cfg"]
    assert c.mapper.use_geometric and c.mapper.use_reprojection
    assert not c.mapper.use_schur and c.loop_closure
    assert c.mapper.pho_iters == (15, 15)
    assert c.mapper.max_back_connections == 4
    assert c.tracking_dist_threshold == 5.0


def test_refine_pair_events_and_accounting_identical(runs):
    a, b = runs["torch"], runs["jax"]
    assert a["kf"] == b["kf"] and a["fr"] == b["fr"]
    assert sum(a["kf"]) >= 3
    assert (a["n_frames"], a["lost"]) == (b["n_frames"], b["lost"])
    assert a["lost"] == 0 and a["ts"] == b["ts"] and len(a["ts"]) == N - 2
    assert a["loops"] == b["loops"]


def test_refine_pair_geo_factors_identical_and_assembled(runs):
    a, b = runs["torch"], runs["jax"]
    assert a["geo"] == b["geo"] and len(a["geo"]) >= 4
    np.testing.assert_array_equal(a["geo_points"], b["geo_points"])
    assert runs["geo_stats"]["iterations"] > 0


def test_refine_pair_poses_close(runs):
    a, b = runs["torch"], runs["jax"]
    np.testing.assert_allclose(a["t"], b["t"], atol=POSE_T_TOL)
    np.testing.assert_allclose(a["q"], b["q"], atol=POSE_Q_TOL)
    assert abs(a["ate"] - b["ate"]) < ATE_TOL
