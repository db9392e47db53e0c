"""The port's viewers (deepfactors_tpu_torch/tools: replay_viewer,
result_viewer, live_viewer) against the JAX package's (tools/), on the CPU.

  - ``build_html`` on a run directory in tests/test_replay_viewer.py's
    layout (written through the port's PNG codec) and on one the port's
    ``save_results`` wrote: the page's DATA object equal to the reference
    tool's, but the surfel arrays (pos / intensity / depth), which must be
    within 1e-6 (both back-project in float32 with the same numpy code, so
    they are found equal);
  - ``result_viewer``: every keyframe's depth colormap equal pixel for
    pixel (decoded, since the reference writes through cv2 and the port
    through its own codec), ``map.ply``'s points within 1e-5 (both print
    4 decimals), and without matplotlib the one line that says
    trajectory.png was not written, the rest written;
  - ``LiveViewer`` on tests/test_replay_viewer.py's live scenario, the JAX
    facade with the JAX viewer and the port's with the port's (RANSAC draws
    from JAX's key chain, port_tools/threefry_chain.py): the same keyframe
    files and ids, an auto-refreshing page mid-run, none after ``finish()``.
"""
import base64
import json
import os
import sys

import numpy as np
import pytest
import torch

from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.loop import vocabulary as jvb
from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
from deepfactors_tpu.system import DeepFactors as JDF
from deepfactors_tpu.system import SystemConfig as JSC
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.io import image_io
from deepfactors_tpu_torch.io import synth as tsynth
from deepfactors_tpu_torch.loop import vocabulary as tvb
from deepfactors_tpu_torch.mapping.mapper import MapperConfig as TMC
from deepfactors_tpu_torch.system import DeepFactors as TDF
from deepfactors_tpu_torch.system import SystemConfig as TSC
from deepfactors_tpu_torch.tools import live_viewer as tlv
from deepfactors_tpu_torch.tools import replay_viewer as trv
from deepfactors_tpu_torch.tools import result_viewer as tresv
from port_tools.threefry_chain import KeyChain
from tools import live_viewer as jlv
from tools import replay_viewer as jrv
from tools import result_viewer as jresv

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)
H, W, N = 48, 64, 14
KW = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)
SURFEL_TOL = 1e-6
PLY_TOL = 1e-5


def _layout_run_dir(d):
    """tests/test_replay_viewer.py's run directory, written through the
    port's PNG codec."""
    h, w = 24, 32
    img = (np.linspace(0, 255, h * w).reshape(h, w)).astype(np.uint8)
    dpt = (2.0 * 5000 * np.ones((h, w))).astype(np.uint16)
    dpt[0, 0] = 0  # a hole: must be dropped, not back-projected
    for kid in (0, 3):
        image_io.imwrite(os.path.join(d, f"kf_{kid}_img.png"), img)
        image_io.imwrite(os.path.join(d, f"kf_{kid}_dpt.png"), dpt)
    with open(os.path.join(d, "keyframes.txt"), "w") as f:
        f.write("0 0 0 0 0 0 0 1\n3 0.5 0 0 0 0 0 1\n")
    with open(os.path.join(d, "trajectory.txt"), "w") as f:
        for i in range(6):
            f.write(f"{i} {0.1 * i} 0 0 0 0 0 1\n")
    with open(os.path.join(d, "intrinsics.txt"), "w") as f:
        f.write("30.0 30.0 16.0 12.0\n")


def _assert_same_page(html_port, html_ref):
    a, b = trv.page_data(html_port), trv.page_data(html_ref)
    arrays = ("pos", "inten", "dep")
    strip = lambda d: dict(d, keyframes=[
        {k: v for k, v in kf.items() if k not in arrays}
        for kf in d["keyframes"]])
    assert json.dumps(strip(a)) == json.dumps(strip(b))
    for ka, kb in zip(a["keyframes"], b["keyframes"]):
        for k in arrays:
            x = np.frombuffer(base64.b64decode(ka[k]), np.float32)
            y = np.frombuffer(base64.b64decode(kb[k]), np.float32)
            assert x.shape == y.shape and x.size > 0
            np.testing.assert_allclose(x, y, rtol=0, atol=SURFEL_TOL)
    # the page around the data is the reference's, verbatim
    assert (html_port.split("const DATA = ")[0]
            == html_ref.split("const DATA = ")[0])


def test_build_html_matches_reference_on_the_test_layout(tmp_path):
    d = str(tmp_path)
    _layout_run_dir(d)
    for stride in (1, 2):
        _assert_same_page(trv.build_html(trv.load_run(d), stride, 8.0),
                          jrv.build_html(jrv.load_run(d), stride, 8.0))
    data = trv.page_data(trv.build_html(trv.load_run(d), 1, 8.0))
    pos = np.frombuffer(base64.b64decode(data["keyframes"][0]["pos"]),
                        np.float32).reshape(-1, 3)
    assert pos.shape[0] == 24 * 32 - 1        # the hole dropped


def _facades():
    scene = jsynth.random_room(11, n_boxes=2, freq_scale=0.3)
    poses = jsynth.orbit_trajectory(N, radius=0.5, sweep=0.5 * np.pi)
    frames, depths = jsynth.render_sequence(scene, JCam.create(**KW), poses,
                                            H, W, with_depth=True)
    frames = [np.array(f) for f in frames]
    depths = [np.array(x) for x in depths]

    def cfg(SC, MC):
        return SC(mapper=MC(max_keyframes=4, max_frames=1, max_factors=16,
                            code_size=4, height=H, width=W,
                            pyramid_levels=2, pho_iters=(2, 3),
                            connection_mode="LASTN", max_back_connections=2,
                            use_schur=False),
                  dist_threshold=0.6, frame_dist_threshold=0.5,
                  loop_closure=True, loop_active_window=3, loop_max_dist=0.3)

    jvoc = jvb.random_vocabulary(64)
    jdf = JDF(cfg(JSC, JMC), JCam.create(**KW),
              decoder=jsynth.OracleDecoder(frames, depths, levels=2,
                                           code_size=4), vocabulary=jvoc)
    tdf = TDF(cfg(TSC, TMC), TCam.create(**KW),
              decoder=tsynth.OracleDecoder(frames, depths, levels=2,
                                           code_size=4),
              vocabulary=tvb.random_vocabulary(64, device="cpu"),
              device="cpu")
    tdf.mapper.ransac_draw = KeyChain()
    return frames, jdf, tdf


def _live_run(df, LV, d, frames):
    """tests/test_replay_viewer.py's live scenario: whether an
    auto-refreshing page was seen mid-run, the keyframe files, the final
    page."""
    lv = LV(d, df, every=3)
    df.bootstrap_two_frames(frames[0], frames[1])
    df.trajectory = [(0.0, df.pose_wc)]
    mid = False
    for i in range(2, N):
        df.process_frame(float(i), frames[i])
        p = os.path.join(d, "viewer.html")
        if os.path.exists(p):
            with open(p) as f:
                mid |= "http-equiv=\"refresh\"" in f.read()
    files = sorted(f for f in os.listdir(d) if f.startswith("kf_"))
    lv.finish()
    with open(os.path.join(d, "viewer.html")) as f:
        return mid, files, f.read()


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    frames, jdf, tdf = _facades()
    dj = str(tmp_path_factory.mktemp("live_jax"))
    dt = str(tmp_path_factory.mktemp("live_port"))
    ref = _live_run(jdf, jlv.LiveViewer, dj, frames)
    port = _live_run(tdf, tlv.LiveViewer, dt, frames)
    saved = str(tmp_path_factory.mktemp("saved"))
    tdf.save_results(saved)
    return dict(ref=ref, port=port, dj=dj, dt=dt, saved=saved, tdf=tdf)


def test_live_viewer_streams_like_reference(live):
    (mid_j, files_j, final_j), (mid_t, files_t, final_t) = \
        live["ref"], live["port"]
    assert mid_j and mid_t, "no auto-refreshing viewer.html mid-run"
    assert files_t == files_j and len(files_t) >= 4, (files_t, files_j)
    for final in (final_j, final_t):
        assert "http-equiv=\"refresh\"" not in final
        assert "const DATA" in final
    ids = lambda html: [k["id"] for k in trv.page_data(html)["keyframes"]]
    assert ids(final_t) == ids(final_j)
    # the callbacks are detached again
    assert live["tdf"].map_callback is None
    assert live["tdf"].pose_callback is None


def test_build_html_matches_reference_on_save_results(live):
    d = live["saved"]
    run = trv.load_run(d)
    assert len(run["kf_files"]) >= 2 and run["trajectory"]
    for stride in (2, 3):
        _assert_same_page(trv.build_html(run, stride, 8.0),
                          jrv.build_html(jrv.load_run(d), stride, 8.0))
    assert trv.main([d, "--device", "cpu"]) == 0
    assert os.path.getsize(os.path.join(d, "viewer.html")) > 10_000


def _ply_points(path):
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    return np.array([[float(x) for x in ln.split()] for ln in lines[start:]])


def test_result_viewer_matches_reference(live, tmp_path, capsys):
    d = live["saved"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jresv.main([d, "--out", out_j]) == 0
    assert tresv.main([d, "--out", out_t, "--device", "cpu"]) == 0
    names = sorted(os.listdir(out_j))
    assert sorted(os.listdir(out_t)) == names
    colour = [n for n in names if n.endswith("_depth_color.png")]
    assert len(colour) >= 2 and "trajectory.png" in names
    for n in colour:
        a = cv2.imread(os.path.join(out_t, n), cv2.IMREAD_COLOR)
        b = cv2.imread(os.path.join(out_j, n), cv2.IMREAD_COLOR)
        assert a.shape == b.shape and np.array_equal(a, b), n
    pa = _ply_points(os.path.join(out_t, "map.ply"))
    pb = _ply_points(os.path.join(out_j, "map.ply"))
    assert pa.shape == pb.shape and len(pa) > 0
    np.testing.assert_allclose(pa, pb, rtol=0, atol=PLY_TOL)


def test_result_viewer_without_matplotlib(live, tmp_path, capsys,
                                          monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "no_mpl")
    assert tresv.main([live["saved"], "--out", out, "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "trajectory.png NOT written: matplotlib does not import" in said
    names = os.listdir(out)
    assert "trajectory.png" not in names and "map.ply" in names
    assert any(n.endswith("_depth_color.png") for n in names)
