"""The port's demo entry against the JAX package's, continued (see
test_torch_demo.py for the setting and the tolerances): a source of
another size through ``set_source_camera`` (the JAX side through
``port_tools/jax_demo_reference.py``, which preprocesses each frame once)
with ``--dump_state=true`` (the same dump files, keyframes and mosaic
layout), and the crash directory of a ``files://`` source whose fifth image is
corrupt."""
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "port_tools"))

import jax_demo_reference  # noqa: E402
from test_torch_demo import ATE_REL_TOL, REMAP_Q_TOL, REMAP_T_TOL, \
    _same_results, demo_frames, make_net  # noqa: E402

from deepfactors_tpu_torch import demo  # noqa: E402
from deepfactors_tpu_torch.io import image_io  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    return make_net(str(tmp_path_factory.mktemp("net")))


def test_demo_through_set_source_camera(tmp_path, net):
    argv = ["--source", "synthetic://128x96:8", "--dump_state=true", *net]
    calls = []
    df, summary = demo.run(
        ["--device", "cpu", "--log_dir", str(tmp_path / "port"), *argv],
        on_system=lambda d: calls.append(d._remap), log=lambda s: None)
    assert calls and calls[0] is not None       # remapped
    assert summary["frames"] == 6 and summary["tracked"] == 1.0
    assert summary["ate"] is not None and np.isfinite(summary["ate"])
    jdf, readings, _ = jax_demo_reference.run(
        ["--log_dir", str(tmp_path / "jax"), *argv], quiet=True)
    assert readings["keyframes"] == summary["keyframes"]
    assert abs(readings["ate"] - summary["ate"]) <= \
        ATE_REL_TOL * readings["ate"]
    _same_results(str(tmp_path / "port"), str(tmp_path / "jax"),
                  t_tol=REMAP_T_TOL, q_tol=REMAP_Q_TOL)
    # --dump_state: the map dump, the factor graph and the error mosaics
    import json

    port = tmp_path / "port"
    for f in ("state.json", "factor_graph.dot", "photo_errors.png"):
        assert (port / f).exists(), f
    a = json.loads((port / "state.json").read_text())
    b = json.loads((tmp_path / "jax" / "state.json").read_text())
    assert [k["id"] for k in a["keyframes"]] == [k["id"] for k in b["keyframes"]]
    assert (image_io.imread(str(port / "photo_errors.png"), "color").shape
            == image_io.imread(str(tmp_path / "jax" / "photo_errors.png"),
                               "color").shape)


def test_demo_crash_directory(tmp_path, net):
    src = tmp_path / "frames"
    os.makedirs(src)
    frames = [f.img for f in demo_frames(6)]
    for i, img in enumerate(frames):
        image_io.imwrite(str(src / f"{i}.png"),
                         (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
    (src / "4.png").write_bytes(b"not a png")
    argv = ["--source", f"files://{src}", *net]
    with pytest.raises(IOError):
        demo.run(["--device", "cpu", "--log_dir", str(tmp_path / "port"),
                  *argv], log=lambda s: None)
    import df_demo

    with pytest.raises(IOError):
        df_demo.main(["--log_dir", str(tmp_path / "jax"), *argv])
    crash = [str(tmp_path / p / "crash") for p in ("port", "jax")]
    assert "crash" in os.listdir(crash[0])
    _same_results(*crash, crash=True)
