"""Layered configuration: flag files, command-line flags, typed configs.

PyTorch port of ``deepfactors_tpu/config.py``, the reference's three config
tiers (SURVEY.md section 5):
  (1) CLI flags with ``--flagfile`` composition (gflags, demo/main.cpp:
      26-110, and the layered files data/flags/common.flags ->
      alg_*.flags -> dataset_*.flags, read where they are);
  (2) the typed option structs (DeepFactorsOptions -> MapperOptions ...),
      here the port's ``SystemConfig`` / ``MapperConfig``;
  (3) JSON network configs (decoder_network.cpp:231-325), here the port's
      decoder ``NetworkConfig``.

Flag files are plain ``--key=value`` lines; later files override earlier
ones and CLI flags override files. ``build_system_config`` translates the
flat flag dict field by field as the JAX package does, with the same
defaults, which are not always the dataclasses' (``use_schur`` is False
here and True in ``MapperConfig``; ``loop_sigma`` 1.0 here, 0.05 in
``SystemConfig``).
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .mapping.mapper import MapperConfig
from .system import SystemConfig


def parse_flag_line(line: str):
    """One flag-file line -> (key, value), or None for a blank or comment
    line; ``--name`` reads true and ``--noname`` false."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if not line.startswith("--"):
        raise ValueError(f"Invalid flag line: {line}")
    body = line[2:]
    if "=" in body:
        k, v = body.split("=", 1)
        return k.strip(), v.strip()
    if body.startswith("no"):
        return body[2:], "false"
    return body, "true"


def load_flagfile(path: str, flags: Optional[dict] = None) -> dict:
    """Load a flag file into ``flags`` (a new dict unless given), following
    ``--flagfile`` includes relative to the including file."""
    flags = {} if flags is None else flags
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            kv = parse_flag_line(line)
            if kv is None:
                continue
            k, v = kv
            if k == "flagfile":
                inc = v if os.path.isabs(v) else os.path.join(base, v)
                load_flagfile(inc, flags)
            else:
                flags[k] = v
    return flags


def parse_args(argv, flags: Optional[dict] = None) -> dict:
    """CLI arguments (--k=v, --k v, --k, --flagfile=path) into a flat dict;
    the positional arguments go to ``__positional__``."""
    flags = {} if flags is None else flags
    i = 0
    positional = []
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                k, v = a[2:], argv[i + 1]
                i += 1
            else:
                k, v = a[2:], "true"
            if k == "flagfile":
                load_flagfile(v, flags)
            else:
                flags[k] = v
        else:
            positional.append(a)
        i += 1
    flags["__positional__"] = positional
    return flags


def _get(flags, key, typ, default):
    """flags[key] as ``typ`` (bool from 1/true/yes/on, tuple from a comma
    list of ints), ``default`` when absent."""
    if key not in flags:
        return default
    v = flags[key]
    if typ is bool:
        return str(v).lower() in ("1", "true", "yes", "on")
    if typ is tuple:
        return tuple(int(x) for x in str(v).split(","))
    return typ(v)


_KEYFRAME_MODES = {"AUTO", "AUTO_COMBINED", "NEVER"}
_TRACKING_MODES = {"CLOSEST", "LAST", "FIRST"}
_CONN_MODES = {"FULL", "LASTN", "FIRST", "LAST"}


def _fit(levels: tuple, n: int) -> tuple:
    """An iteration list cut or padded (with its last entry) to n levels."""
    return tuple(list(levels)[:n]) + tuple([levels[-1]] * max(0, n - len(levels)))


def build_system_config(flags: dict, height: int, width: int) -> SystemConfig:
    """Flat flags -> typed config (deepfactors_options.cpp and demo
    main.cpp:112-130). The enum flags are upper-cased and validated."""
    pyramid_levels = _get(flags, "pyramid_levels", int, 3)
    pho_iters = _get(flags, "pho_iters", tuple, (15, 15, 30))
    if len(pho_iters) != pyramid_levels:
        pho_iters = _fit(pho_iters, pyramid_levels)

    conn = _get(flags, "connection_mode", str, "LASTN").upper()
    kf_mode = _get(flags, "keyframe_mode", str, "AUTO").upper()
    trk_mode = _get(flags, "tracking_mode", str, "CLOSEST").upper()
    for val, allowed, name in ((conn, _CONN_MODES, "connection_mode"),
                               (kf_mode, _KEYFRAME_MODES, "keyframe_mode"),
                               (trk_mode, _TRACKING_MODES, "tracking_mode")):
        if val not in allowed:
            raise ValueError(f"Invalid {name}: {val} (allowed: {allowed})")

    mapper = MapperConfig(
        max_keyframes=_get(flags, "max_keyframes", int, 16),
        max_frames=_get(flags, "max_frames", int, 2),
        max_factors=_get(flags, "max_factors", int, 64),
        code_size=_get(flags, "code_size", int, 32),
        height=height,
        width=width,
        pyramid_levels=pyramid_levels,
        pho_iters=pho_iters,
        huber_delta=_get(flags, "huber_delta", float, 0.3),
        avg_dpt=_get(flags, "avg_dpt", float, 2.0),
        code_prior=_get(flags, "code_prior", float, 1.0),
        pose_prior=_get(flags, "pose_prior", float, 0.3),
        relin_threshold=_get(flags, "relinearize_threshold", float, 0.05),
        connection_mode=conn,
        max_back_connections=_get(flags, "max_back_connections", int, 4),
        use_photometric=_get(flags, "use_photometric", bool, True),
        use_reprojection=_get(flags, "use_reprojection", bool, True),
        max_keypoints=_get(flags, "rep_nfeatures", int, 128),
        rep_max_dist=_get(flags, "rep_max_dist", float, 30.0),
        rep_huber=_get(flags, "rep_huber", float, 0.1),
        rep_iters=_get(flags, "rep_iters", int, 15),
        rep_sigma=_get(flags, "rep_sigma", float, 1.0),
        rep_ransac_maxiters=_get(flags, "rep_ransac_maxiters", int, 128),
        rep_ransac_threshold=_get(flags, "rep_ransac_threshold", float, 1e-4),
        use_geometric=_get(flags, "use_geometric", bool, False),
        geo_npoints=_get(flags, "geo_npoints", int, 128),
        geo_stochastic=_get(flags, "geo_stochastic", bool, False),
        geo_huber=_get(flags, "geo_huber", float, 0.1),
        geo_iters=_get(flags, "geo_iters", int, 15),
        use_schur=_get(flags, "use_schur", bool, False),
    )
    tracking_iters = _fit(_get(flags, "tracking_iterations", tuple, (10, 5, 4)),
                          pyramid_levels)
    return SystemConfig(
        mapper=mapper,
        tracking_iterations=tracking_iters,
        tracking_mode=trk_mode,
        tracking_huber_delta=_get(flags, "tracking_huber_delta", float, 0.3),
        tracking_error_threshold=_get(flags, "tracking_error_threshold",
                                      float, 0.3),
        tracking_dist_threshold=_get(flags, "tracking_dist_threshold",
                                     float, 2.0),
        keyframe_mode=kf_mode,
        inlier_threshold=_get(flags, "inlier_threshold", float, 0.5),
        dist_threshold=_get(flags, "dist_threshold", float, 2.0),
        frame_dist_threshold=_get(flags, "frame_dist_threshold", float, 0.2),
        combined_threshold=_get(flags, "combined_threshold", float, 2.0),
        loop_closure=_get(flags, "loop_closure", bool, True),
        loop_max_dist=_get(flags, "loop_max_dist", float, 0.5),
        loop_active_window=_get(flags, "loop_active_window", int, 10),
        loop_sigma=_get(flags, "loop_sigma", float, 1.0),
        loop_min_similarity=_get(flags, "loop_min_similarity", float, 0.35),
        loop_max_candidates=_get(flags, "loop_max_candidates", int, 10),
        interleave_mapping=_get(flags, "interleave_mapping", bool, False),
        predict_code=_get(flags, "predict_code", bool, True),
    )


def load_network_config(path: str):
    """JSON network config (LoadJsonNetworkConfig,
    decoder_network.cpp:231-325) -> the decoder's ``NetworkConfig``, its
    architecture (``base_ch``, ``pred_head``) included. The trained
    intrinsics are read from a ``"camera"`` object, as the reference reads
    them; the shipped networks hold none, so ``fx`` is 0 for them."""
    from .models.decoder import NetworkConfig

    with open(path) as f:
        j = json.load(f)
    cam = j.get("camera", {})
    default = NetworkConfig()
    return NetworkConfig(
        code_size=j.get("code_size", 32),
        pyramid_levels=j.get("pyramid_levels", 4),
        input_width=j.get("input_width", 256),
        input_height=j.get("input_height", 192),
        avg_dpt=j.get("avg_dpt", 2.0),
        fx=cam.get("fx", 0.0),
        fy=cam.get("fy", 0.0),
        u0=cam.get("u0", 0.0),
        v0=cam.get("v0", 0.0),
        grayscale=j.get("grayscale", True),
        base_ch=j.get("base_ch", default.base_ch),
        pred_head=j.get("pred_head", default.pred_head),
    )


def save_run_flags(dir_path: str, flags: dict):
    """Write the run's flags to ``dir_path``/flags.txt, one ``--k=v`` line
    each, sorted (run-directory provenance, demo/main.cpp:131-138)."""
    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, "flags.txt"), "w") as f:
        for k, v in sorted(flags.items()):
            if k != "__positional__":
                f.write(f"--{k}={v}\n")
