"""``SystemConfig.frame_upload`` of the pipelined facade against the JAX
facade, on the CPU.

tests/test_torch_pipeline_pair.py's scene and configuration (48x64, the
orbit of random_room(11), loop closure on with JAX's vocabulary carried
across, depth 1), the first UPLOAD_FRAMES frames, with the frames uploaded
as uint8 (widened on the device) and as float16. The decoder is a random
``Decoder`` of both packages on the same weights: the JAX mapper then
builds a keyframe from the frame step's pyramids of the uploaded frame, as
the port's does (with the ground-truth ``OracleDecoder`` it would decode
the host frame instead). The decisions must be identical frame for frame,
the poses within tests/test_torch_system.py's POSE_T_TOL / POSE_Q_TOL, and
the images of the keyframes built from uploaded frames, as the mapper
holds them, within POOL_TOL (a frame quantised to uint8 moves them by up
to 1/510, to float16 by up to 2.4e-4)."""
import numpy as np
import pytest
import torch
from test_torch_decoder import random_decoder_params
from test_torch_pipeline_pair import KW, H, W, N, _cfg, _decisions, _run
from test_torch_system import POSE_Q_TOL, POSE_T_TOL

from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.loop import vocabulary as jvb
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.models.decoder import Decoder as JDec
from deepfactors_tpu.models.decoder import NetworkConfig as JNC
from deepfactors_tpu.system import DeepFactors as JDF
from deepfactors_tpu.system import SystemConfig as JSC
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.loop import vocabulary as tvb
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.models.decoder import Decoder as TDec
from deepfactors_tpu_torch.models.decoder import NetworkConfig as TNC
from deepfactors_tpu_torch.system import DeepFactors as TDF
from deepfactors_tpu_torch.system import SystemConfig as TSC

torch.set_num_threads(2)
UPLOAD_FRAMES = 10
POOL_TOL = 1e-6


@pytest.fixture(scope="module")
def frames():
    sc = jsynth.random_room(11, n_boxes=2, freq_scale=0.3)
    poses = jsynth.orbit_trajectory(N, radius=0.5, sweep=1.2 * np.pi)
    return [np.array(f) for f in jsynth.render_sequence(
        sc, JCam.create(**KW), poses[:UPLOAD_FRAMES], H, W)]


@pytest.mark.parametrize("upload", ["u8", "f16"])
def test_frame_upload_pair(frames, upload):
    ncfg = dict(code_size=4, pyramid_levels=2, input_width=W, input_height=H,
                base_ch=8)
    params = random_decoder_params(JNC(**ncfg), seed=0)
    jvoc = jvb.random_vocabulary(64)
    jdf = JDF(_cfg(JSC, JMC, 1, upload), JCam.create(**KW),
              decoder=JDec(JNC(**ncfg), params=params), vocabulary=jvoc)
    tdf = TDF(_cfg(TSC, TMC, 1, upload), TCam.create(**KW),
              decoder=TDec(TNC(**ncfg), params=params, device="cpu"),
              vocabulary=tvb.vocabulary_from_numpy(
                  np.asarray(jvoc.words), np.asarray(jvoc.idf), "cpu"),
              device="cpu")
    b, a = _run(jdf, frames, UPLOAD_FRAMES), _run(tdf, frames, UPLOAD_FRAMES)
    assert _decisions(a) == _decisions(b)
    assert sum(r["keyframe"] for r in a["recs"]) >= 1
    assert a["n_frames"] == b["n_frames"] == UPLOAD_FRAMES - 2
    assert a["lost"] == b["lost"] == 0 and a["pending"] == 0
    assert a["ts"] == b["ts"]
    np.testing.assert_allclose(a["t"], b["t"], atol=POSE_T_TOL)
    np.testing.assert_allclose(a["q"], b["q"], atol=POSE_Q_TOL)
    # the keyframes built after the bootstrap hold the uploaded frames
    built = tdf.mapper.kf_slots[2:]
    assert built and built == jdf.mapper.kf_slots[2:]
    np.testing.assert_allclose(
        tdf.mapper.state.levels[0].img[built].numpy(),
        np.asarray(jdf.mapper.state.levels[0].img)[built], rtol=0,
        atol=POOL_TOL)
