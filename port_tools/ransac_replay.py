"""Replay one keyframe event's match + RANSAC of the bench row in both
packages, with the JAX mapper's own draws, and say for each direction
whether the hypothesis that decided it is well posed.

The bench row (``jax_smoke_reference.py --bench-sequence --pipeline-depth
1 --scene-seed 7``) runs in the JAX facade up to ``--frame`` (fed up to it,
then ``flush()``), recording the inputs of the mapper's jitted match +
RANSAC call (keypoints, descriptors, the event's key). The call of the
keyframe event that retires last is replayed:

- the JAX side: the mapper's jitted call, and a jitted replica that
  returns every hypothesis's inlier count;
- the port's side: ``features.matching.match`` and the eight-point RANSAC
  on the same keypoints, with the same draws (the JAX key split per
  direction, as ``Mapper._rep_pair_fn`` splits it);
- in float64: each hypothesis's 8x9 system, its 8th singular value over
  its 1st (well posed above 1e-4, as ``ransac_rank_deficient.py`` and
  ``tests/test_torch_loop_correction.py`` hold it), and its inliers.

With ``--port-run`` the port's own facade also runs the row on the CPU up
to the same frame with JAX's draws replayed, and its keypoints of the
event are compared with JAX's.

With ``--demo-source URL --frame-limit N`` the run is the demo entry's in
``chip_smoke.py`` phase 10's configuration (``DEMO_FLAGS``) in place of
the bench row: ``df_demo.py`` through ``port_tools/jax_demo_reference.py``
on JAX's side, ``deepfactors_tpu_torch.demo.run`` with JAX's draws
replayed on the port's (with ``--port-run``); the event replayed is the
last of the first N processed frames.

For each direction it prints the matches, the inliers each way keeps, the
hypothesis each package picked (its index, how many distinct matches it
draws, its count, its singular-value ratio, its count in float64), the number of well-posed hypotheses, the
most inliers a well-posed one keeps in float64, and each well-posed
hypothesis whose counts differ between the packages.

Run on the CPU from the repository root (about 2 minutes; 3 with
``--port-run``):
    JAX_PLATFORMS=cpu python port_tools/ransac_replay.py --frame 21 \\
        [--port-run]
    JAX_PLATFORMS=cpu python port_tools/ransac_replay.py --port-run \\
        --demo-source tum://build/demo_tum --frame-limit 11
Prints one JSON line.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

H, W = 192, 256
WARM = 10
WELL_POSED = 1e-4


def _jax_decoder():
    from deepfactors_tpu.models.decoder import (Decoder, NetworkConfig,
                                                load_params)
    prefix = os.path.join(ROOT, "data", "nets", "room256_32v4")
    with open(prefix + ".json") as f:
        nj = json.load(f)
    ncfg = NetworkConfig(
        code_size=nj["code_size"], pyramid_levels=nj["pyramid_levels"],
        input_width=nj["input_width"], input_height=nj["input_height"],
        avg_dpt=nj["avg_dpt"], base_ch=nj.get("base_ch", 32),
        pred_head=nj.get("pred_head", "gap"))
    return Decoder(ncfg, params=load_params(prefix + ".pkl"))


def jax_event(scene_seed, frame):
    """The JAX facade's bench row up to ``frame``: the inputs of the last
    match + RANSAC call and the mapper's packed result."""
    from deepfactors_tpu.geometry.camera import PinholeCamera
    from deepfactors_tpu.io import synth
    from tools.bench_e2e import build_system

    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    frames = synth.render_sequence(synth.random_room(scene_seed, n_boxes=3),
                                   cam, synth.orbit_trajectory(300), H, W)
    df = build_system(cam, H, W, _jax_decoder(), max_keyframes=10,
                      dist_threshold=2.0, loop_closure=True,
                      use_reprojection=True, pipeline_depth=1)
    df.prewarm()
    pairs = df.mapper._rep_pair_fn()
    calls = []

    def recorded(kp_xy, kp_desc, kp_valid, ias, ibs, key, n):
        out = pairs(kp_xy, kp_desc, kp_valid, ias, ibs, key, n)
        calls.append(dict(kp_xy=np.asarray(kp_xy), kp_desc=np.asarray(kp_desc),
                          kp_valid=np.asarray(kp_valid),
                          ias=np.asarray(ias).tolist(),
                          ibs=np.asarray(ibs).tolist(), key=key,
                          packed=np.asarray(out)))
        return out

    df.mapper._rep_pair_jit = recorded
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    for i in range(3, frame + 1):
        df.process_frame(float(i), frames[i])
        if i == 2 + WARM:
            df.flush()
    df.flush()
    return cam, calls[-1], df.mapper.cfg


def _demo_argv(source, frame_limit):
    import chip_smoke as cs
    return [*cs.DEMO_FLAGS, "--source", source, "--frame_limit",
            str(frame_limit)]


def jax_demo_event(source, frame_limit):
    """``df_demo.py`` (through jax_demo_reference.py) on ``source`` for
    ``frame_limit`` frames: the inputs of its last match + RANSAC call."""
    import tempfile

    import jax_demo_reference

    calls, mappers = [], []

    def hook(df):
        m = df.mapper
        pairs = m._rep_pair_fn()
        mappers.append(m)

        def recorded(kp_xy, kp_desc, kp_valid, ias, ibs, key, n):
            out = pairs(kp_xy, kp_desc, kp_valid, ias, ibs, key, n)
            calls.append(dict(
                kp_xy=np.asarray(kp_xy), kp_desc=np.asarray(kp_desc),
                kp_valid=np.asarray(kp_valid), ias=np.asarray(ias).tolist(),
                ibs=np.asarray(ibs).tolist(), key=key,
                packed=np.asarray(out)))
            return out

        m._rep_pair_jit = recorded

    with tempfile.TemporaryDirectory() as d:
        jax_demo_reference.run(_demo_argv(source, frame_limit)
                               + ["--log_dir", d], quiet=True,
                               on_system=hook)
    m = mappers[-1]
    return m.cam, calls[-1], m.cfg


def port_demo_event(source, frame_limit):
    """The port's demo on the CPU over the same source and frames, JAX's
    draws replayed: the keypoint pools of its last match + RANSAC call."""
    import tempfile

    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_mapper_rep import JaxKeyChain
    from deepfactors_tpu_torch import demo
    from deepfactors_tpu_torch.mapping.mapper import Mapper

    torch.set_num_threads(4)
    rep_pairs, seen = Mapper._rep_pairs, []

    def recorded(self, slot_pairs):
        out = rep_pairs(self, slot_pairs)
        st = self.state
        seen.append(dict(kp_xy=st.kp_xy.numpy().copy(),
                         kp_desc=st.kp_desc.numpy().copy(),
                         kp_valid=st.kp_valid.numpy().copy(),
                         pairs=[list(p) for p in slot_pairs],
                         packed=out.numpy().copy()))
        return out

    def hook(df):
        chain = JaxKeyChain()
        df.mapper.ransac_draw, df.mapper.geo_draw = chain, chain.geo

    Mapper._rep_pairs = recorded
    try:
        with tempfile.TemporaryDirectory() as d:
            demo.run(_demo_argv(source, frame_limit)
                     + ["--device", "cpu", "--log_dir", d], on_system=hook,
                     log=lambda m: None)
    finally:
        Mapper._rep_pairs = rep_pairs
    return seen[-1]


def port_event(scene_seed, frame):
    """The port's facade on the CPU over the same row and frames, JAX's
    draws replayed: the keypoint pools of its last match + RANSAC call."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke as cs
    from test_torch_mapper_rep import JaxKeyChain
    from deepfactors_tpu_torch.mapping.mapper import Mapper
    from deepfactors_tpu_torch.models.decoder import load_decoder

    torch.set_num_threads(4)
    rep_pairs, seen = Mapper._rep_pairs, []

    def recorded(self, slot_pairs):
        out = rep_pairs(self, slot_pairs)
        st = self.state
        seen.append(dict(kp_xy=st.kp_xy.numpy().copy(),
                         kp_desc=st.kp_desc.numpy().copy(),
                         kp_valid=st.kp_valid.numpy().copy(),
                         pairs=[list(p) for p in slot_pairs],
                         packed=out.numpy().copy()))
        return out

    Mapper._rep_pairs = recorded
    try:
        dec = load_decoder(os.path.join(ROOT, "data", "nets", "room256_32v4"),
                           device="cpu")
        cs.run_pipelined("cpu", dec, "port", scene_seed=scene_seed,
                         ransac_draw=JaxKeyChain(), audit=None,
                         stop=frame + 1, checks=False)
    finally:
        Mapper._rep_pairs = rep_pairs
    return seen[-1]


def f64_hypotheses(idx, b0, b1, valid, threshold):
    """Per hypothesis: the 8th over the 1st singular value of its 8x9
    system, and its inliers with the null vector projected onto the
    essential manifold, all in float64."""
    A = (b1[idx][..., :, None] * b0[idx][..., None, :]).reshape(-1, 8, 9)
    _, sv, vt = np.linalg.svd(A, full_matrices=True)
    E = vt[:, -1].reshape(-1, 3, 3)
    u, _, v = np.linalg.svd(E)
    E = u[..., :, :2] @ v[..., :2, :]
    Eb0 = np.einsum("hij,nj->hni", E, b0)
    Etb1 = np.einsum("nj,hjk->hnk", b1, E)
    x = np.sum(b1[None] * Eb0, axis=-1)
    den = (Eb0[..., 0] ** 2 + Eb0[..., 1] ** 2 + Etb1[..., 0] ** 2
           + Etb1[..., 1] ** 2)
    inl = (x * x / np.maximum(den, 1e-12) < threshold) & valid[None]
    return sv[:, 7] / sv[:, 0], inl.sum(-1)


def replay(cam, call, cfg, port):
    import jax.numpy as jnp
    import torch
    from deepfactors_tpu.features import matching as jm
    from deepfactors_tpu_torch.features import matching as pm
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera as PCam

    pcam = PCam.create(fx=float(cam.fx), fy=float(cam.fy),
                       u0=float(cam.u0), v0=float(cam.v0),
                       width=int(cam.width), height=int(cam.height))
    thr, iters = cfg.rep_ransac_threshold, cfg.rep_ransac_maxiters
    n = len(call["ias"])
    ks = jax.random.split(call["key"], 2 * n)
    dirs = [d for a, b in zip(call["ias"], call["ibs"])
            for d in ((a, b), (b, a))]

    @jax.jit
    def counts(kp0, kp1, valid, idx):
        b0, b1 = jm.bearing_vectors(cam, kp0), jm.bearing_vectors(cam, kp1)
        Es = jax.vmap(lambda i: jm._essential_from_8(b0[i], b1[i]))(idx)
        errs = jax.vmap(lambda E: jm._epipolar_error(E, b0, b1))(Es)
        return jnp.sum((errs < thr) & valid[None], axis=-1)

    xy, desc, kv = call["kp_xy"], call["kp_desc"], call["kp_valid"]
    t = lambda a: torch.from_numpy(np.array(a))
    out = []
    for d, (a, b) in enumerate(dirs):
        mm = jm.match(desc[a], kv[a], desc[b], kv[b],
                      max_dist=int(cfg.rep_max_dist))
        valid = np.asarray(mm.valid)
        kp0, kp1 = xy[a], xy[b][np.asarray(mm.idx1)]
        idx = np.asarray(jax.random.categorical(
            ks[d], jnp.where(valid, 0.0, -1e9), shape=(iters, 8)))
        jc = np.asarray(counts(kp0, kp1, valid, idx))
        # the port on the same keypoints and draws
        pmm = pm.match(t(desc[a].view(np.int32)), t(kv[a]),
                       t(desc[b].view(np.int32)), t(kv[b]),
                       max_dist=int(cfg.rep_max_dist))
        pk1 = t(xy[b])[pmm.idx1.long()]
        pb0 = pm.bearing_vectors(pcam, t(kp0))
        pb1 = pm.bearing_vectors(pcam, pk1)
        ti = t(idx).long()
        Es = pm._essential_from_8(pb0[ti], pb1[ti])
        pc = ((pm._epipolar_error(Es, pb0, pb1) < thr)
              & pmm.valid[None]).sum(-1).numpy()
        pinl = pm.prune_matches_eight_point(t(kp0), pk1, pmm.valid, pcam,
                                            idx=ti, threshold=thr)
        b0 = np.asarray(jm.bearing_vectors(cam, kp0), np.float64)
        b1 = np.asarray(jm.bearing_vectors(cam, kp1), np.float64)
        ratio, c64 = f64_hypotheses(idx, b0, b1, valid, thr)
        posed = ratio > WELL_POSED
        jw, pw = int(np.argmax(jc)), int(np.argmax(pc))
        row = dict(
            direction=[a, b], matches_jax=int(valid.sum()),
            matches_port=int(pmm.valid.sum()),
            same_matches=bool(np.array_equal(valid, pmm.valid.numpy())
                              and np.array_equal(np.asarray(mm.idx1),
                                                 pmm.idx1.numpy())),
            inliers_jax_mapper=int((call["packed"][d, :, 4] > 0.5).sum()),
            inliers_jax_replica=int(jc.max()),
            inliers_port=int((pinl & pmm.valid).sum()),
            jax_pick=dict(hyp=jw, distinct=len(set(idx[jw].tolist())),
                          inliers=int(jc[jw]),
                          sv_ratio=float(ratio[jw]), inliers_f64=int(c64[jw]),
                          port_count=int(pc[jw])),
            port_pick=dict(hyp=pw, distinct=len(set(idx[pw].tolist())),
                           inliers=int(pc[pw]),
                           sv_ratio=float(ratio[pw]), inliers_f64=int(c64[pw]),
                           jax_count=int(jc[pw])),
            hypotheses=int(len(idx)), well_posed=int(posed.sum()),
            best_well_posed_f64=int(c64[posed].max()) if posed.any() else 0,
            counts_differ=int((jc != pc).sum()),
            # each well-posed hypothesis whose counts differ: its index,
            # its counts in JAX, the port and float64, its ratio
            well_posed_differ=[
                [int(h), int(jc[h]), int(pc[h]), int(c64[h]),
                 float(ratio[h])]
                for h in np.nonzero((jc != pc) & posed)[0]])
        if port is not None:
            pd = [x for p in port["pairs"] for x in (tuple(p), tuple(p[::-1]))]
            row["inliers_port_run"] = int(
                (port["packed"][pd.index((a, b)), :, 4] > 0.5).sum())
        out.append(row)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene-seed", type=int, default=7)
    ap.add_argument("--frame", type=int, default=21,
                    help="the last frame fed (its keyframe event is replayed)")
    ap.add_argument("--port-run", action="store_true",
                    help="also run the port's facade on the CPU to the same "
                         "frame and compare its keypoints with JAX's")
    ap.add_argument("--demo-source", default=None,
                    help="replay the demo entry's run on this source URL")
    ap.add_argument("--frame-limit", type=int, default=11,
                    help="with --demo-source: the frames processed")
    args = ap.parse_args()
    if args.demo_source:
        cam, call, cfg = jax_demo_event(args.demo_source, args.frame_limit)
        port = (port_demo_event(args.demo_source, args.frame_limit)
                if args.port_run else None)
        res = dict(demo_source=args.demo_source,
                   frame_limit=args.frame_limit)
    else:
        cam, call, cfg = jax_event(args.scene_seed, args.frame)
        port = (port_event(args.scene_seed, args.frame) if args.port_run
                else None)
        res = dict(scene_seed=args.scene_seed, frame=args.frame)
    res["pairs"] = list(zip(call["ias"], call["ibs"]))
    if port is not None:
        used = sorted({s for p in port["pairs"] for s in p})
        res["port_pairs"] = port["pairs"]
        res["port_keypoints_equal"] = dict(
            slots=used,
            xy_max_abs=float(np.abs(port["kp_xy"][used]
                                    - call["kp_xy"][used]).max()),
            desc=bool(np.array_equal(port["kp_desc"][used],
                                     call["kp_desc"][used].view(np.int32))),
            valid=bool(np.array_equal(port["kp_valid"][used],
                                      call["kp_valid"][used])))
    res["directions"] = replay(cam, call, cfg, port)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
