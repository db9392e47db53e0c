"""Map inspection of deepfactors_tpu_torch.mapping.mapper against the JAX
Mapper: ``dump_state(verbose_errors=True)`` and ``save_graphs`` on a map
that has outlived its window (48x64, 2 levels, ``max_keyframes=3``, the room
sequence and decoder outputs of tests/test_torch_eviction.py: two
evictions, then a one-way frame whose work is still outstanding).

Before the dump the port's estimate is set to the JAX mapper's, so the two
dumps describe one map. They must have the same keys and the same keyframe
table, works, links and archive; per live keyframe-to-keyframe factor the
inlier counts are equal and the residuals agree to rtol 1e-3 (the port
evaluates all factors of a level in one ``sfm_error_batch`` call, the JAX
dump one ``sfm_evaluate_error`` per factor: fp32 sums in another order and
the two interpolation forms of tests/test_torch_sfm_error.py). The graph
files hold the same edges."""
import json

import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params
from test_torch_eviction import _JaxOutputsDecoder, _sync

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.mapping.mapper import Mapper as JMapper
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.models.decoder import Decoder as JDec
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping.mapper import Mapper as TMapper
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.ops.kernels import sfm_error as tse

torch.set_num_threads(2)
H, W, CS = 48, 64, 4
RES_RTOL = 1e-3


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    kw = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)[:10]
    frames = [np.array(f) for f in
              jsynth.render_sequence(scene, JCam.create(**kw), poses, H, W)]
    rel = [jse3.mul(jse3.inverse(poses[0]), p) for p in poses]
    ncfg = dict(code_size=CS, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    jdec = JDec(JNC(**ncfg), params=random_decoder_params(JNC(**ncfg), seed=0))
    mk = lambda MC: MC(max_keyframes=3, max_frames=2, max_factors=16,
                       code_size=CS, height=H, width=W, pyramid_levels=2,
                       pho_iters=(4, 8), max_back_connections=2,
                       use_reprojection=False)
    jm = JMapper(mk(JMC), JCam.create(**kw), decoder=jdec)
    tm = TMapper(mk(TMC), TCam.create(**kw), decoder=_JaxOutputsDecoder(jdec),
                 device="cpu")
    for m, SE in ((jm, JSE3), (tm, TSE3)):
        pose = lambda i: SE(np.array(rel[i].q, np.float32),
                            np.array(rel[i].t, np.float32))
        m.init_two_frames(frames[0], frames[2])
        for i in (4, 6, 8):
            m.protected_slots = set(m.kf_slots[-2:])
            m.enqueue_keyframe(frames[i], pose(i))
            while m.has_work():
                m.mapping_run()
            m.update_map()
        m.enqueue_frame(frames[9], pose(9), m.kf_slots[-1])
    _sync(tm, jm)
    tse.reset_launch_counts()
    out = {}
    for name, m in (("jax", jm), ("torch", tm)):
        path = str(tmp_path_factory.mktemp(name) / "graph.dot")
        m.save_graphs(path)
        with open(path) as f:
            out[name] = dict(dump=m.dump_state(verbose_errors=True),
                             plain=m.dump_state(), dot=f.read())
    return out


def test_dump_has_the_jax_dumps_keys_and_is_json(maps):
    a, b = maps["torch"]["dump"], maps["jax"]["dump"]
    assert set(a) == set(b)
    for key in ("keyframes", "works", "photo_factors", "archived"):
        assert len(a[key]) == len(b[key]) > 0, key
        for ra, rb in zip(a[key], b[key]):
            assert set(ra) == set(rb), key
    assert a["rep_factors"] == a["geo_factors"] == []
    json.dumps(a)


def test_dump_tables_match_jax(maps):
    a, b = maps["torch"]["dump"], maps["jax"]["dump"]
    assert a["works"] == b["works"]
    assert a["links"] == b["links"]
    assert len(a["keyframes"]) == 3 and len(a["archived"]) == 2
    for ra, rb in zip(a["keyframes"], b["keyframes"]):
        assert (ra["slot"], ra["id"], ra["has_marginal_prior"]) == \
            (rb["slot"], rb["id"], rb["has_marginal_prior"])
        np.testing.assert_allclose(ra["t"], rb["t"], atol=1e-4)
        assert abs(ra["code_norm"] - rb["code_norm"]) <= 1e-4
    for ra, rb in zip(a["archived"], b["archived"]):
        assert ra["id"] == rb["id"]
        np.testing.assert_allclose(ra["q"], rb["q"], atol=1e-4)
        np.testing.assert_allclose(ra["t"], rb["t"], atol=1e-4)


def test_per_factor_errors_match_jax(maps):
    a, b = maps["torch"]["dump"], maps["jax"]["dump"]
    kf_kf = 0
    for ra, rb in zip(a["photo_factors"], b["photo_factors"]):
        for k in ("slot", "src", "dst", "dst_is_frame", "level"):
            assert ra[k] == rb[k], k
        assert ("residual" in ra) == ("residual" in rb) == (not ra["dst_is_frame"])
        if not ra["dst_is_frame"]:
            kf_kf += 1
            assert ra["inliers"] == rb["inliers"] > 0
            assert np.isfinite(ra["residual"])
            np.testing.assert_allclose(ra["residual"], rb["residual"],
                                       rtol=RES_RTOL, atol=2e-6)
    assert kf_kf >= 2


def test_plain_dump_carries_no_errors(maps):
    for row in maps["torch"]["plain"]["photo_factors"]:
        assert "residual" not in row and "inliers" not in row


def test_save_graphs_writes_the_same_edges(maps):
    a, b = maps["torch"]["dot"], maps["jax"]["dot"]
    assert a == b
    assert "graph factors" in a and "pho L" in a and "shape=diamond" in a


def test_cpu_dump_never_launches_a_kernel(maps):
    assert tse.LAUNCHES == {"sfm_error_batch": 0, "se3_warp_batch": 0}
