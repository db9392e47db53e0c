"""profile_event: the pieces of a keyframe event at the bench
configuration, host time against device time.

PyTorch port of the JAX package's ``tools/profile_event.py``, on the
facade of ``bench_config.bench_system`` (tools/bench_e2e.py's
``build_system(max_keyframes=10, dist_threshold=2.0)``: reprojection
factors and loop closure on, room256_32v4) after ``prewarm()``, its mapper
filled to capacity with 10 keyframes of ``random_room(7)``'s orbit. Each
piece is timed by ``common.time_stage`` (host ms, CUDA-event µs, the
profiler's kernel µs and kernel count per call):
  - the keyframe build: the decoder forward, the predicted-code gate
    (``sfm_error_batch``), detection, the pool write, and the whole
    ``Mapper.add_keyframe_to_map`` into a free slot (undone after each
    call, so that every call builds into the same slot);
  - match + RANSAC over n = 1 and 2 keyframe pairs (``Mapper._rep_pairs``);
  - the device side of an eviction (``Mapper._eliminate``) at its (P, N);
  - the coarse-to-fine descent (``Mapper.run_segments``) over the
    segments (2, 16), (1, 9), (0, 5);
  - ``Mapper.update_map``.
The pieces run on the live mapper: the eviction's repeated calls add to
the neighbours' marginal priors, the descent moves the map, and one real
eviction frees the slot of the build. The numbers are timings, not a run.

Usage: python -m deepfactors_tpu_torch.tools.profile_event [--n 5]
       [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from ..config import parse_args
from ..geometry import se3 as se3m
from ..io import synth
from ..mapping import map_state as ms
from ..ops import image as ip
from .bench_config import (H, W, bench_camera, bench_system,
                           load_bench_decoder)
from .common import device_from_flag, time_stage

N_KF = 10


def _undo_keyframe(m, slot):
    """Take the keyframe ``add_keyframe_to_map`` just built out again."""
    m.kf_slots.remove(slot)
    m._next_kid -= 1
    del m.kf_ids[m._next_kid]
    m.state.active[slot] = False
    m.state.next_id.sub_(1)


def main(argv, log=print) -> dict:
    """Time every piece; returns {piece: StageTime as a dict}."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    n = int(flags.get("n", 5))
    cam = bench_camera()
    df = bench_system(cam, load_bench_decoder(dev), dev, max_keyframes=N_KF,
                      dist_threshold=2.0, pipeline_depth=0)
    m = df.mapper
    df.prewarm()
    poses = synth.orbit_trajectory(24)
    frames = synth.render_sequence(synth.random_room(7, n_boxes=3), cam,
                                   poses, H, W, device=dev)
    # fill to capacity so that evictions are exercised
    for i in range(N_KF):
        m.enqueue_keyframe(frames[i], se3m.identity(device=dev))
        while m.has_work():
            m.mapping_run()
    m.update_map()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"{len(m.kf_slots)} keyframes on {name}; per call: host clock, "
        f"CUDA events, profiler kernels")
    out = {}

    def piece(label, fn, reps=n):
        t = time_stage(fn, dev, n=reps, warmup=1)
        log(f"{label:<34}: {t}")
        out[label] = t._asdict()

    # match + RANSAC over n back-connections
    a, b = m.kf_slots[-1], m.kf_slots[-2]
    for k in (1, 2):
        piece(f"rep match+RANSAC n={k}",
              lambda k=k: m._rep_pairs([(a, b)] * k))

    # the device side of an eviction
    victim = m._select_victim()
    facs, neighbors = m._victim_factors(victim)
    if facs:
        piece(f"evict P={len(facs)} N={len(neighbors)}",
              lambda: m._eliminate(victim, facs, neighbors))

    # the coarse-to-fine descent
    L = m.cfg.pyramid_levels
    segs = tuple((l, m.cfg.pho_iters[l] + 1) for l in range(L - 1, -1, -1))
    m._bookkeeping()
    pool, descent = m._compact_pool(extra=m.sched.descent_slots())
    piece(f"C2F descent segs={segs}",
          lambda: m.run_segments(pool, descent, segs), reps=max(1, n // 2))
    piece("update_map", m.update_map)

    # the keyframe build into the slot one real eviction frees
    m.marginalize_keyframe(victim)
    img = torch.as_tensor(frames[N_KF + 1], device=dev)
    img_pyr = tuple(ip.build_pyramid(img, L))
    grad_pyr = tuple(ip.build_gradient_pyramid(img_pyr))
    pose = se3m.identity(device=dev)
    dec = m.decoder.raw_outputs_T(img_pyr[0])
    gs = m.kf_slots[-1]
    prx_pred = dec["prx0"][0] + torch.einsum("chw,c->hw", dec["jac"][0],
                                             dec["code_pred"])
    feats = m._detect(img_pyr)
    zero = torch.zeros((m.cfg.code_size,), device=dev)

    def write():
        ms.add_keyframe(m.state, victim, pose, zero, img_pyr, grad_pyr,
                        dec["prx0"], dec["jac"], dec["stdev"],
                        m.cfg.avg_dpt, features=feats)
        m.state.active[victim] = False
        m.state.next_id.sub_(1)

    def build():
        slot = m.add_keyframe_to_map(img, pose, pyramids_in=(img_pyr,
                                                             grad_pyr))
        _undo_keyframe(m, slot)

    piece("kf build: decoder", lambda: m.decoder.raw_outputs_T(img_pyr[0]))
    piece("kf build: gate (sfm_error_batch)",
          lambda: m._gate_errors((prx_pred, dec["prx0"][0]), pose,
                                 img_pyr[0], gs))
    piece("kf build: detect", lambda: m._detect(img_pyr))
    piece("kf build: write", write)
    piece("kf build (add_keyframe_to_map)", build)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
