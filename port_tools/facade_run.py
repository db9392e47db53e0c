"""One run of the port's sequential facade on the synthetic room orbit, on
the GPU, with the scene, length and keyframe window given on the command
line: chip_smoke.py's end-to-end runner (``run_facade``) outside its fixed
phases. Prints the readings chip_smoke.py prints for a phase (latencies by
event kind, evictions, keyframes, tracked fraction, rigid ATE, ATE every 20
frames, kernel launches), then one JSON line. ``--use-reprojection``
switches the reprojection factors on (the mapper's default configuration;
chip_smoke.py's phase 4) and adds their readings; ``--loop-closure``
switches loop closure on with the shipped vocabulary (with
``--use-reprojection --loop-active-window 8 --loop-max-dist 0.35``:
tools/bench_e2e.py's flagship configuration, chip_smoke.py's phase 7) and
adds the loop counters, every dense verification and every
relocalisation. A lost frame relocalises.

The frame latencies it prints come from a run without timing of the
parts; ``--time-parts`` adds the host milliseconds of the parts (evictions,
detection, match + RANSAC, rep assembly, dense verification,
relocalisation, every ``detect_pyramid`` call), each timed between two
synchronises, which then fall inside the frame latencies. ``--trace FILE``
writes the per-frame decision trace of ``port_tools/decision_trace.py``.
``--device cpu`` runs the kernels' plain twins on the CPU (no launches);
``--decoder-device cpu`` evaluates only the decoder on the CPU, its outputs
moved to the run's device (it separates the decoder's rounding from the
rest's); ``--plain-kernels`` replaces the launchers of kernels 1-4 by their
plain twins on the run's tensors (a diagnostic: it separates the kernels'
rounding from the rest's; the launch counts stay 0); ``--cpu-draws`` makes
the RANSAC draws on the CPU, from a generator seeded 42 as the port's
mapper on the CPU seeds its own (a card run then sees the hypotheses of a
CPU run: the draws of a CUDA generator differ).

``--bench-sequence`` runs bench.py's end-to-end row instead
(chip_smoke.py's phase 8, ``run_pipelined``): ``orbit_trajectory(--frames)``
with its default sweep (300 frames unless given), tools/bench_e2e.py's
``build_system(max_keyframes=10, ...)`` at ``--pipeline-depth N`` (N frames
in flight; 0, sequential, unless given), ``prewarm()``, bootstrap on frames
0 and 2, 10 warm frames, ``flush()``, the timed frames (``e2e_fps``),
``flush()``. ``--sync-audit error`` runs its dispatches under
``torch.cuda.set_sync_debug_mode``, ``warn`` lists every synchronising call
site; the audit's cost then falls inside ``e2e_fps`` and the latencies (off
unless given). ``--pipeline-depth`` is taken only with
``--bench-sequence``.

The counterpart on the CPU for the JAX package, with the same arguments, is
``port_tools/jax_smoke_reference.py``.

Run from the repository root on a machine with a GPU:
    python3 port_tools/facade_run.py --scene-seed 5 --frames 180 \\
        --max-keyframes 16 --max-factors 64 [--repeat 2] [--use-reprojection]
    python3 port_tools/facade_run.py --scene-seed 42 --frames 186 \
        --use-reprojection --loop-closure --loop-active-window 8 \
        --loop-max-dist 0.35 [--time-parts]
    python3 port_tools/facade_run.py --bench-sequence --pipeline-depth 1 \
        --scene-seed 7 [--sync-audit error|warn] [--repeat 2]
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class DecoderOn:
    """A decoder evaluated on its own device, its outputs moved to
    ``device``: the mapper reads only ``raw_outputs_T``."""

    def __init__(self, dec, device):
        self.dec, self.device = dec, device

    def raw_outputs_T(self, img):
        out = self.dec.raw_outputs_T(img.to(self.dec.device))
        return {k: tuple(x.to(self.device) for x in v)
                if isinstance(v, tuple) else v.to(self.device)
                for k, v in out.items()}


def plain_kernels():
    """Route kernels 1-4 to their plain twins on any device."""
    from deepfactors_tpu_torch.ops.kernels import sfm_error as se
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    def launch(name, params, src, dst, img0, dpt, img1, active, render):
        if render:
            return se.se3_warp_batch_plain(params, src, dst, img0, dpt, img1,
                                           active)
        return (None,) + tuple(se.sfm_error_batch_plain(
            params, src, dst, img0, dpt, img1, active))

    sg._se3_gram_cuda = sg.se3_gram_batch_plain
    sg._sfm_gram_cuda = sg.sfm_gram_batch_plain
    se._launch = launch


def cpu_draws():
    """A ``Mapper.ransac_draw`` that draws on the CPU (seed 42)."""
    import torch
    from deepfactors_tpu_torch.features import matching as mt
    g = torch.Generator().manual_seed(42)
    return lambda valids, iters: mt.draw_hypotheses(
        valids.cpu(), iters, g).to(valids.device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene-seed", type=int, default=7)
    # the one-way-frame policy's distance (0.12 in every configuration of
    # chip_smoke.py); other values probe how far a run depends on one
    # decision falling a frame earlier or later
    ap.add_argument("--frame-dist-threshold", type=float, default=0.12)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the orbit (60; 300 with --bench-sequence)")
    ap.add_argument("--max-keyframes", type=int, default=32)
    ap.add_argument("--max-factors", type=int, default=128)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--use-reprojection", action="store_true")
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--loop-active-window", type=int, default=10)
    ap.add_argument("--loop-max-dist", type=float, default=0.5)
    ap.add_argument("--time-parts", action="store_true")
    ap.add_argument("--trace", default=None,
                    help="write the per-frame decision trace here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--decoder-device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--plain-kernels", action="store_true")
    ap.add_argument("--cpu-draws", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=0)
    ap.add_argument("--bench-sequence", action="store_true")
    ap.add_argument("--stop", type=int, default=None,
                    help="with --bench-sequence: feed frames up to stop - 1 "
                         "only (the orbit's pacing stays that of --frames)")
    ap.add_argument("--sync-audit", default="off",
                    choices=("error", "warn", "off"))
    args = ap.parse_args()
    if args.pipeline_depth and not args.bench_sequence:
        ap.error("--pipeline-depth is taken only with --bench-sequence")
    args.frames = args.frames or (300 if args.bench_sequence else 60)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("facade_run: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch.models.decoder import load_decoder
    from deepfactors_tpu_torch.ops.kernels import build

    smi = cs.smi_line() if args.device == "cuda" else "cpu"
    print(smi, flush=True)
    if args.device == "cuda":
        build.build_all()
    if args.plain_kernels:
        plain_kernels()
    dec = load_decoder(os.path.join(ROOT, "data", "nets", "room256_32v4"),
                       device=args.decoder_device or args.device)
    if (args.decoder_device or args.device) != args.device:
        dec = DecoderOn(dec, args.device)
    for rep in range(args.repeat):
        if args.bench_sequence:
            r = cs.run_pipelined(
                args.device, dec, f"run {rep}", args.scene_seed,
                n_frames=args.frames, depth=args.pipeline_depth,
                audit=None if args.sync_audit == "off" else args.sync_audit,
                ransac_draw=cpu_draws() if args.cpu_draws else None,
                stop=args.stop, trace=args.trace)
            df = r["df"]
            print(json.dumps({
                "device": smi, "scene_seed": args.scene_seed,
                "frames": args.frames, "pipeline_depth": args.pipeline_depth,
                "e2e_fps": r["e2e_fps"], "ate_m": r["ate"],
                "tracked_fraction": r["tracked"],
                "n_lost_frames": df.n_lost_frames, "n_frames": df.n_frames,
                "trajectory_len": len(df.trajectory),
                "n_keyframes_built": df.mapper._next_kid,
                "n_evictions": df.n_evictions, "loops": r["loops"],
                "loops_at": r["loop_at"],
                "n_relocalizations": df.n_relocalizations,
                "tracking_only_ms": r["ms_by"]["tracking-only frames"],
                "audited_dispatches": r["audited"],
                "sync_sites": len(r["sync_sites"]),
                "launches": cs.launch_counts()}), flush=True)
            continue
        r = cs.run_facade(args.device, dec, f"run {rep}", args.scene_seed,
                          args.frames, args.max_keyframes, args.max_factors,
                          frame_dist_threshold=args.frame_dist_threshold,
                          use_reprojection=args.use_reprojection,
                          loop_closure=args.loop_closure,
                          loop_active_window=args.loop_active_window,
                          loop_max_dist=args.loop_max_dist,
                          time_parts=args.time_parts, trace=args.trace,
                          ransac_draw=cpu_draws() if args.cpu_draws else None)
        df = r["df"]
        print(json.dumps({
            "device": smi, "scene_seed": args.scene_seed,
            "frames": args.frames, "max_keyframes": args.max_keyframes,
            "frame_dist_threshold": args.frame_dist_threshold,
            "use_reprojection": args.use_reprojection,
            "n_rep_factors_live": int(df.mapper.rep_pool.active.sum())
            if args.use_reprojection else 0,
            "loop_closure": args.loop_closure,
            "loop_active_window": args.loop_active_window,
            "loop_max_dist": args.loop_max_dist,
            "n_local_links": df.n_local_links,
            "n_live_global_loops": df.n_live_global_loops,
            "n_archived_loops": df.n_archived_loops,
            "loops_at": r["loop_at"],
            "n_lost_frames": df.n_lost_frames,
            "n_relocalizations": df.n_relocalizations,
            "relocalisations": r["relocs"],
            "ate_m": r["ate"], "tracked_fraction": r["tracked"],
            "n_keyframes_built": df.mapper._next_kid,
            "n_evictions": df.n_evictions,
            "ate_keyframes_evictions_at": r["ate_at"],
            "launches": cs.launch_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
