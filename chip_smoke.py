"""Smoke run of the PyTorch/CUDA port (deepfactors_tpu_torch) on one GPU.

Phases, in order (any failure exits non-zero before the final line):
  1. card name + power limit (nvidia-smi); build the CUDA kernels from
     deepfactors_tpu_torch/csrc (one nvcc per source, in parallel).
  2. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (192x256, 96x128, 48x64 levels, K = 32 keyframe pools):
     sfm_gram_batch at P = 128 with half the slots inactive, CS 32 and 8,
     Huber/Tukey, from-prox on/off, interp/sampled; se3_gram_batch at
     P = 1 and 8, and at the loop paths' P = 10, 16, 32, 64 (candidates in
     a pool of their own against one current frame, interp, three levels;
     timed at 192x256); both again at sizes no tile divides (90x122,
     89x121, CS 64 and 5), at P = 1, with every factor inactive, and launched
     repeatedly (the same bits, also after another P and size), beside the
     time of an empty launch; sfm_error_batch and se3_warp_batch at one P
     for every distinct launch plan of P = 1..128 (half the slots inactive)
     at the three sizes and at 90x122 and 89x121, all inactive, launched
     repeatedly, and timed at the keyframe gate, the map dump and one
     render; dense_warp_batch at P = 16 and 64; bilinear_warp_planes at
     C = 1, 3, 4, 5, 9 at every distinct launch plan, through both entries
     (stacked planes, planes read in place), bit-identical to its twin, timed
     at C = 3, and the sampling stage of sfm_step in turns with the first
     design (built from port_tools/variants/bilinear_warp_first.cu); the Gram
     kernels with no active against all active. Times kernel and twin with
     CUDA events.
  2c. jacobian_stack against its twin on the card at one chunk of the
     large map (P = 124, 192x256, CS 32), Huber and Tukey: Jw (pose rows
     included) and rw bit for bit, and JtJ after the bmm; the largest
     difference of Jw and rw from the twin's in the kernels line; NaN rows
     where tptz is 0 in the same places; kernel, bound and twin times, one
     launch a call. ``--only-jacobian`` runs phases 1, 2c, 3,
     6a and 6b.
  2b. the reprojection operators (plain PyTorch, no kernel of their own) on
     the card against the port on the CPU, on one rendered 192x256 frame
     pair with ~90 matches: detect_pyramid (valid keypoints identical,
     descriptors within 1 bit a keypoint and 2 over both frames), match on
     identical descriptors (identical), prune_matches_eight_point with the
     same draws (the same inlier mask but for errors on the threshold),
     reprojection_system (JtJ and Jtr within REP_SYS_TOL of each block's
     largest entry, inliers equal), and the loop closure's BoW with the
     shipped vocabulary (every descriptor's word identical, similarities
     within BOW_SIM_TOL); each timed on the card.
  3. the room256_32v4 decoder forward at 192x256 on the card, held against
     the same module on the CPU.
  4. end to end in the default configuration: the sequential DeepFactors
     facade with reprojection factors on (tools/bench_e2e.py's
     configuration without loop closure) on 60 frames of the synthetic
     room orbit in a window of 32 keyframes, bootstrap on frames 0 and 2;
     rep factors must be built and assembled into the GN iterations.
     Keyframe-event latency is split into detection, match + RANSAC and
     rep assembly per GN iteration.
  5. the long run: the same facade and orbit with the package's default
     window (max_keyframes=16, max_factors=64), 180 frames, so the run
     outlives its window and evicts; then the map dump with per-factor
     errors (sfm_error_batch) and one warp render (se3_warp_batch).
     Reprojection factors stay off here: with them on, the JAX facade
     itself loses tracking in this room at frame 70 (PERF.md section 6).
  6. the parallel/ entry points, single card, full width: (a) the dry-run
     BA step (K = 8, CS 32, 16 factors at 192x256) through the kernels,
     against the same step assembled from the plain twins; (b) a large map
     of 32 decoded keyframes and 236 factors, ``LargeMapBA`` for 10
     iterations (dense_warp_batch, jacobian_stack); (c)
     ``BatchedOdometry`` over 8 rooms for 30 frames (se3_gram_batch at
     P = 8, sampled gradients); and one ``sfm_step``
     (bilinear_warp_planes).
  7. loop closure in the flagship configuration (tools/bench_e2e.py's
     build_system: reprojection factors and loop closure on, active window
     8, loop_max_dist 0.35, 32 keyframes, the shipped vocabulary) on 186
     frames of random_room(42): every frame tracked, a global loop accepted
     through the batched dense verification (se3_gram_batch at P = 10 a GN
     iteration), the loop counters, the loop's frame and link, and the ATE
     held to the JAX facade's CPU run;
     7b. relocalisation in the same configuration with a window of 8: a
     noise frame, then a recovery against the live pool (P = 8); evictions,
     a noise frame, then frame 0 recovered against the archive (P = 64),
     the matched archived keyframe resurrected; each relocalised pose near
     the truth.
     They run between phases 4 and 5.
  8. the pipelined facade on bench.py's end-to-end row (after phase 7b):
     tools/bench_e2e.py's build_system(max_keyframes=10, ...) at
     pipeline_depth=1 on the 300 frames of orbit_trajectory(300) (its
     default sweep) of random_room(7), after prewarm(): 10 warm frames,
     flush(), the timed frames (bench.py's e2e_fps), flush(). Every frame
     tracked, the JAX facade's frame accounting, nothing left in flight,
     the ATE under a bound set from the JAX facade's CPU runs and the
     card's, loop candidates verified, kernels 1-3 launched; pinned
     uploads and pinned probe reads bit-identical to the device's values.
     Prints the tracking-only host latencies beside phase 7's sequential
     ones. Then the sync audit, in a pass of its own over the row's first
     60 frames: every dispatch of a timed frame under
     torch.cuda.set_sync_debug_mode("error"); and the row of random_room(42),
     where the card closes archived loops: every frame tracked, at least
     one archived loop.
  9. the reference's refinement configuration (after phase 6): the
     sequential facade built by the port's config.build_system_config from
     data/flags/alg_refine.flags (reprojection and geometric factors and
     loop closure on, pho_iters 15,15,30, 4 back-connections, a window of
     16, the dense solve) with the orbit's tracking_dist_threshold of 5.0,
     on 100 frames of random_room(7): every frame tracked, geometric
     factors drawn at every keyframe event and assembled into the GN
     iterations, no Schur solve, kernels 1-3 launched, the ATE under a
     bound set from the JAX facade's CPU run and the card's; prints the
     host latencies by event kind and the geo factor counts.
     9a. (first) geometric_system at the path's shapes, 16 factors of 128
     points, CS 32: card against CPU, each block within 1e-4, validity and
     nearest-pixel lookups identical but at round-off of an integer
     (counted); timed.
     9b. (second) the depth-prior scenario of tests/test_mapper.py:174 at
     192x256: the code the JAX package's CPU run reaches, and the first GN
     iteration's fall in the depth error within 10% of JAX's.
  10. the demo entry (after phase 9): ``deepfactors_tpu_torch.demo.run`` on
     the card with data/flags/dataset_odom.flags (reprojection factors and
     loop closure on), room256_32v4 and tracking_dist_threshold 5.0, on
     data written under build/phase10 by port_tools/demo_data.py:
     10a. TUM's layout at 640x480 (room 7's orbit at TUM's intrinsics,
     remapped to 256x192), 16 frames, twice: with the port's own RANSAC
     draws (every frame tracked, the ATE under a bound set from JAX's demo
     over its key seeds, the keyframe count in their range, the run
     directory's files), then with JAX's draws (port_tools/threefry_chain.py):
     the keyframe poses after frame 11 held to JAX's keyframes.txt there,
     and the ATE after frame 12's keyframe event, where the RANSAC of
     rank-deficient hypotheses parts every run (ROADMAP C), under a bound
     set from JAX's and the card's readings;
     10b. files:// at 320x240 (no ground truth): the decoded frames equal
     the frames written, bit for bit; the run, with JAX's draws, completes
     its limit and loses as many frames as JAX's demo and builds as many
     keyframes, each event within a frame of JAX's;
     10c. synthetic://320x240:30: its frames rendered on the card within
     1e-5 of the CPU's, every frame tracked, the ATE under JAX's bound;
     10d. phase 4's configuration on the native C++ scheduler, a Python
     scheduler shadowing it call for call (the same pools and budgets at
     every bookkeeping), then the Python scheduler alone: the same keyframe
     and rep-factor counts, the ATE within NATIVE_ATE_TOL_M;
     10e. a checkpoint after a keyframe event of that configuration,
     restored into a fresh system that goes on: its poses within
     RESUME_TOL_M of 10d's uninterrupted run.
     Each prints host ms per frame by event kind, kernels 1-3 launches, the
     ATE and the files written. ``--only-demo`` runs phases 1, 3 and 10.
  11. decoder training (after phase 10; no kernel of its own: the U-Net's
     convolutions are cuDNN's bf16 conv2d, as in phase 3):
     11a. one step of the recipe (tools/train_room_decoder.py's VAEModel at
     room256_32v4's width, batch 8 at 192x256, clip + adamw under the
     cosine schedule) from room256_32v4's decoder and a seeded encoder, with
     JAX's eps (port_tools/threefry_chain.py): the card against the port on
     the CPU, loss and terms, the gradient norm, every leaf's gradient and
     the parameters after the update; timed;
     11b. the same step against JAX's make_train_step on a CPU
     (TRAIN_JAX, from port_tools/jax_train_reference.py);
     11c. ``train_room_decoder.main`` on the card with --randomize, from
     flax's default init, 16 rooms x 16 views, 300 steps at batch 8: the
     nll of the last 50 steps below the first 50's, ms per step, peak
     device memory, held-out RMSEs; the weights written under build/phase11
     read back by ``load_decoder`` and linear in the code;
     11d. phase 4's configuration on 20 frames with 11c's decoder: every
     frame tracked, the ATE printed (not bounded).
     ``--only-train`` runs phases 1 and 11.
  12. the tools (after phase 11; deepfactors_tpu_torch/tools, no kernel of
     their own), each on the card at 192x256 with room256_32v4 through its
     ``main``: LiveViewer on the first 30 frames of phase 4's configuration
     (a refreshing page during the run, none after ``finish()``, every
     keyframe's files), then the run directory's replay and result viewers;
     decode_image (the proximity maps and code against the CPU's);
     test_matching; voc_builder (k-means on the host) and voc_test on
     synthetic://256x192:40, then voc_test over the CPU's render of those
     frames on the card and on the CPU (BoW vectors and scores);
     kernel_benchmark, profile_ba, profile_dispatch (main, n0, fixed) and
     profile_event (host ms, CUDA-event µs, profiler kernel µs and count per
     stage); schur_crossover over K = 4..48 (both solutions of every system
     against the CPU's). Every kernel launched; no cv2 imported.
     ``--only-tools`` runs phases 1 and 12.
  13. several ranks (after phase 12; no kernel of its own). A world of n
     ranks runs NCCL with a card a rank where the machine has n cards, else
     gloo with every rank on cuda:0 (NCCL cannot hold two ranks on one
     card); each rank is a process of its own (``multihost.World``, a file
     rendezvous), none forked. Each sub-phase prints its backend, world
     and card count:
     13a. ``tools.multihost_demo`` at production size (8 factors, K 8, CS
     32, 192x256, 3 BA steps) over 2 ranks, each building only its factor
     rows: the ranks' digests agree, and lie within MULTI_DEMO_TOL of one
     process on the card and of JAX's digest (MULTI_DEMO_JAX);
     dense_warp_batch once a step in each rank;
     13b. ``dryrun.dryrun_matrix`` over worlds 1, 2 and 4 (the dry-run
     problem sharded n ways): every world within 1e-4 of world 1, world 1
     within MULTI_SAME_TOL of 6a's ``dryrun_single`` (the assembly sums
     with float atomics, so not bit for bit);
     13c. an NCCL group of one created and used on this card: the dry-run
     system all_reduced bit for bit (and whether NCCL ran across cards);
     13d. 6c's odometry over 2 ranks of 4 rooms (se3_gram_batch at P = 4
     in each, with the launch plan of P = 8), every pose within
     MULTI_ODO_TOL of 6c's one process;
     13e. 11a's recipe step over 2 ranks of 4 rows against one process,
     then MULTI_RECIPE_STEPS of 11c's recipe through ``train_room_decoder
     --distributed`` (the nll falls, the ranks' parameters bit-identical),
     ms per step at world 2 and world 1.
     ``--only-multi`` runs phases 1 and 13.
  14. the tracer's clock (after phase 13; utils/timing.py): spans around
     one dense_warp_batch launch each (P = 124, 192x256), queued behind a
     spin, under a profiler session: each end of a span's device interval
     (CUDA events placed on the host clock by the tracer's anchor) within
     TRACE_TOL_US of the kernel's CUPTI record, and its host start within
     TRACE_TOL_US of its record_function mirror's. It runs in a process
     of its own (``--only-trace``, which runs phases 1 and 14): late in
     this long process the profiler keeps only 13-14 of the 20 kernel
     records, on the parent commit too.
Then a ``kernels`` JSON line (``launches_by_path["multi"]``: phase 13's
launches, summed over its ranks), the script's time, the nvidia-smi line,
and as the last line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Run from the repository root:  python3 chip_smoke.py
Options: --ptxas (print nvcc's register/shared-memory report); --only-demo;
--only-train; --only-tools; --only-multi; --only-trace; --only-jacobian.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

# Tolerance of kernel vs plain twin, per factor and per block of G, each on
# its own scale: JtJ (G[:DB,:DB]) over max|JtJ|, Jtr (G[:DB,DB]) over
# max|Jtr|, the residual G[DB,DB] relative to itself; the inlier count
# G[DB+1,DB+1] exactly. Both sides are fp32 and compute every pixel's row
# with the same op-by-op rounding (the kernels build with --fmad=false, so
# validity is bit-identical); they differ in the order of the Gram
# summation (strip partials + fixed-order tree in the kernel, cuBLAS in the
# twin). Over 12k-49k pixels that order costs ~sqrt(N)·2^-24 ≈ 1e-5 of a
# block's largest entry; 1e-4 leaves a factor ten. The poses are perturbed
# off the true relative poses (POSE_NOISE) so that residuals and Jtr are
# far from zero and a wrong sign or a missing weight shows.
KERNEL_TOL = 1e-4
POSE_NOISE = (0.02, 0.005)   # translation (m), rotation (rad) per axis
# Rigid ATE bound for the 60-frame run (phase 4, reprojection factors on),
# just above both readings it was set from (PERF.md section 2): the JAX
# facade's own CPU run of the same configuration, 0.0650 m
# (port_tools/jax_smoke_reference.py --use-reprojection), and the port's
# card runs of this script, 0.0637-0.0647 m.
ATE_BOUND_M = 0.08
# The long run (phase 5) runs the same orbit in random_room(5), the room
# in which both packages carry 180 frames in a window of 16 along the same
# path: the JAX facade on the CPU tracks every frame up to 194 and reads, at
# 180, 17 evictions and a rigid ATE of 0.2610 m
# (port_tools/jax_smoke_reference.py --frames 200 --max-keyframes 16
# --max-factors 64 --scene-seed 5); the port on the card reads 17 evictions
# and 0.2602 m (port_tools/facade_run.py, same arguments, 180 frames). The
# bound sits just above both, as ATE_BOUND_M does. Room 7 cannot carry it
# (the JAX facade loses tracking at frame 126, and at 146 in a window of
# 32, before any eviction), and in room 11 one one-way-frame decision at
# frame 51 falls on its threshold and the two packages part there
# (PERF.md section 6).
LONG_SCENE_SEED = 5
LONG_FRAMES = 180
LONG_WINDOW = 16
LONG_ATE_BOUND_M = 0.32
# sfm_error_batch / se3_warp_batch vs their twins: inlier counts equal, the
# residual within ERR_RES_TOL of itself (a sum of non-negative terms in
# another order), the render within WARP_ATOL absolute (the same fp32
# expression per pixel), inactive outputs exactly 0.
ERR_RES_TOL = 1e-4
WARP_ATOL = 1e-5
# decoder card vs CPU: bf16 activations round differently in cuDNN and in
# the CPU convolution; 2e-2 of the largest |value| per output.
DECODER_TOL = 2e-2
# dense_warp_batch / bilinear_warp_planes vs their twins: ``valid`` equal,
# the transformed points and the samples within DENSE_WARP_ATOL absolute
# (one fp32 expression per pixel, rounded op by op on both sides), NaN in
# the same places (a sample at a non-finite coordinate).
DENSE_WARP_ATOL = 1e-6
# bilinear_warp_planes: plane counts checked (bit-identical to the twin) at
# every distinct launch plan: the compile-time kernels (1, 3, 4 planes),
# the general loop (5) and a call that takes two launches (9 > MAX_PLANES)
BILINEAR_CS = (1, 3, 4, 5, 9)
# jacobian_stack (phase 2c): the robust loss's delta, the seed of its
# factor set and of the perturbation of their poses
JSTACK_DELTA = 0.3
JSTACK_SEED = 70
# The first design of bilinear_warp_planes, built beside the kernels and
# timed in turns with the port's in the sampling stage of sfm_step
FIRST_BILINEAR_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "port_tools", "variants",
                                  "bilinear_warp_first.cu")
H, W = 192, 256
N_FRAMES = 60
# phase 2b: two frames of the room 7 orbit with ~100 keypoints each and ~90
# matches between them (the 60-frame run's keyframes hold 10-110), so the
# RANSAC winner is well conditioned; 128 hypotheses as the mapper draws
REP_FRAMES = (26, 30)
REP_RANSAC_ITERS = 128
# reprojection_system card vs CPU: the same expressions per match on both
# sides; the (2M x 44) Jacobian reduces by cuBLAS on the card and by the
# CPU's GEMM, so JtJ and Jtr are held within 1e-4 of each (pose0, pose1,
# code) block's largest entry
REP_SYS_TOL = 1e-4
# BoW card vs CPU (phase 2b): each descriptor's word identical (integer
# Hamming distances, the first minimum), the L1 similarities of 256-word
# vectors within 1e-6 (the same terms summed in another order)
BOW_SIM_TOL = 1e-6
# Device milliseconds of the two Gram kernels' first design (two launches
# each: strip partials, then a reduce pass) at the shapes timed below, at
# 192x256 / 96x128 / 48x64, as chip_smoke.py read them on an NVIDIA H100
# 80GB HBM3 at 700 W before the redesign (PERF.md section 6). Constants,
# not measured in this run: they appear only in the log lines of phase 2,
# labelled so, never in the kernels line. The two designs timed side by
# side in one run: port_tools/compare_designs.py --prev.
PREV_MS = {"sfm_gram_batch": (0.937, 0.253, 0.0885),
           "se3_gram_batch": (0.0173, 0.0099, 0.0099),
           "se3_gram_batch_p8_sampled": (0.0186, 0.0105, 0.0108)}
# Sizes that no tile divides: the first keeps 16-byte aligned planes (H*W a
# multiple of 4: the bulk-copy path with a ragged last tile), the second does
# not (the 4-byte cp.async path).
ODD_HW = (90, 122)
ODD_HW_UNALIGNED = (89, 121)
# Batch sizes checked against the twins besides the timed ones: the factor
# buckets of the mapper (pool of 128: 8, 64, 128; pool of 64: 8, 32, 64) and
# tracking batches around the odometry's eight scenes.
MAPPER_BUCKETS = (8, 32, 64)
SE3_EXTRA_P = (3, 16)
SEQ_LEN = 300

# Phase 6. port_tools/jax_parallel_reference.py imports these constants and
# builds the same two problems with the JAX package on a CPU; the limits
# below sit just above its readings and the card's (PERF.md section 2).
# The large map: every ``stride``-th pose of the orbit in random_room(5) as
# a keyframe, the decoder's predicted depth, links to the last ``back``
# keyframes both ways, poses moved off the truth by ``noise`` (m, rad per
# axis; keyframe 0 stays: the prior pins it).
LARGE = dict(scene_seed=5, K=32, stride=2, back=4, iters=10, noise_seed=11,
             noise=(0.05, 0.02))
LARGE_SFM = dict(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0, valid_border=2)
# The odometry: 8 rooms seen along the first frames of a slow orbit, each
# tracked against its first frame's true depth; a scene takes its live
# frame as the new keyframe after kf_dist metres.
ODO = dict(scene_seeds=(1, 2, 3, 4, 5, 6, 8, 9), frames=30, sweep=0.8 * np.pi,
           levels=3, iters_per_level=(8, 6, 6), huber=0.3, kf_dist=0.08)
# The large map after 10 iterations: the JAX package on a CPU reads a
# residual per inlier of 2.092e-4 (from 1.059e-2) and a keyframe translation
# error of 0.2139 m rmse against the truth (from 0.0790 m: the photometric
# optimum under the decoder's depth, whose scale a monocular BA cannot see,
# lies further from the truth than the perturbed start); the card reads
# 2.09e-4 and 0.2122 m.
LARGE_RPI_BOUND = 3e-4
LARGE_ERR_BOUND_M = 0.25
# The odometry's worst scene (room 3) reads a translation rmse of 0.0483 m
# over the 30 frames in both packages, the other scenes 0.003-0.015 m.
ODO_RMSE_BOUND_M = 0.06
DRYRUN_TOL = 1e-4            # kernels vs twins, per block of (H, b)

# Phase 7, loop closure in the flagship configuration: tools/bench_e2e.py's
# build_system (reprojection factors and loop closure on, loop_active_window
# 8, loop_max_dist 0.35, 32 keyframes, 128 factors, the shipped vocabulary)
# on the orbit of random_room(42), one of BENCH_r05.json's rooms, for
# LOOP_FRAMES frames, sequential. The JAX facade on a CPU
# (port_tools/jax_smoke_reference.py --use-reprojection --loop-closure
# --loop-active-window 8 --loop-max-dist 0.35 --scene-seed 42) tracks every
# frame up to 189 and accepts a live global loop at frame 182 (its one
# candidate verified with an inlier share of 0.6835 against 0.5 and a
# translation of 0.164 m against 0.35) and another at 188, then loses
# tracking at 190; in rooms 7, 11, 13 and 21 it loses tracking before or
# without a loop (PERF.md section 6). The run stops after frame 185: one
# loop, three frames after it.
LOOP_SCENE_SEED = 42
LOOP_FRAMES = 186
LOOP_ACTIVE_WINDOW = 8
LOOP_MAX_DIST = 0.35
# (local links, live global loops, archived loops) of the JAX facade's run;
# the card's four runs read the same, so the counters must be equal
LOOP_COUNTS_JAX = (0, 1, 0)
# the accepted loop in the JAX facade's run and the card's: at frame 182,
# from keyframe slot 29 to slot 0; the card's may fall one frame earlier or
# later (LOOP_FRAME_TOL), its target must be the same
LOOP_AT_JAX = (182, 29, 0)
LOOP_FRAME_TOL = 1
# rigid ATE: the JAX facade on a CPU reads 0.1736 m, the card 0.1728-0.1741
# m over eight runs (the port on a CPU 0.1211-0.1214 m: RANSAC's draws
# differ between the CPU and the card, and its run parts at frame 16; the
# card given the CPU's draws reads 0.1197 m; port_tools/decision_trace.py,
# ROADMAP.md section C); the bound just above
LOOP_ATE_BOUND_M = 0.20
# se3_gram_batch's P on the loop paths: the verification of the global loop
# (loop_max_candidates, padded), relocalisation against the live pool
# (max_keyframes: 16 by default, 32 here) and against the archive
# (loop_archive_cap); checked against the twin in phase 2
LOOP_PS = (10, 16, 32, 64)
# Phase 7b, relocalisation: the same configuration with a window of
# RELOC_WINDOW keyframes, so that the orbit's first keyframes are evicted
# into the archive within RELOC_FRAMES frames. A noise frame (as in
# tests/test_relocalization.py) before frame RELOC_LIVE_AT: the frame after
# it relocalises against the live pool (se3_gram_batch at P =
# RELOC_WINDOW); a noise frame after the last orbit frame, then frames 0, 1
# and 2 again: frame 0 relocalises against the archive (P = 64) and the
# archived keyframe it matches comes back to life. Each relocalised pose
# within RELOC_POSE_BOUND_M of the truth after the trajectory's rigid
# alignment (the card reads 0.129 m at frame 30 and 0.085 m at frame 0, the
# port on a CPU 0.094 and 0.095 m; the run's median 0.077 m). As in
# tests/test_relocalization.py, the
# lost check's error threshold is strict: with the default 0.3 a noise frame
# tracks (its error per pixel reads 0.062 in this room, a tracked frame's
# at most 3e-4; the JAX facade runs the same check).
RELOC_ERROR_THRESHOLD = 0.01
RELOC_WINDOW = 8
RELOC_FRAMES = 60
RELOC_LIVE_AT = 30
RELOC_POSE_BOUND_M = 0.20

# Phase 8, the pipelined facade on bench.py's end-to-end row
# (``bench_e2e(..., pipeline_depth=1)``): tools/bench_e2e.py's
# build_system(max_keyframes=10, dist_threshold=2.0, loop_closure=True,
# use_reprojection=True, pipeline_depth=1) on ``orbit_trajectory(300)``
# (its default sweep, 2.6*pi) of random_room(7), prewarm(), bootstrap on
# frames 0 and 2, PIPE_WARM warm frames, flush(), the timed frames and
# flush() again. The JAX facade on a CPU
# (port_tools/jax_smoke_reference.py --bench-sequence --pipeline-depth 1
# --scene-seed 7): tracked 1.0, 297 frames processed, a trajectory of 298
# poses, 60 keyframes built, 50 evictions, 10 live, loop counters (local,
# live, archived) (0, 0, 3), rigid ATE 0.5130 m. Its loops hang on RANSAC's
# draws: with its key chain seeded 2 instead of 42 (--ransac-seed 2) it
# tracks every frame, closes no loop and reads 0.7121 m; seeded 1, 3 and 4
# it loses tracking at frames 195, 231 and 222. So the phase holds the card
# to the frame accounting, the tracked fraction, the ATE bound and a dense
# verification of loop candidates, and prints the loop counters beside
# JAX's. The card reads tracked 1.0, 60 keyframes, 50 evictions, no loop and
# 0.7219-0.7223 m over four runs in two calls; the bound sits above every
# reading of both packages.
# Then the same row in random_room(PIPE_LOOP_SCENE_SEED), for the archived-
# loop path on the card (phase 7 closes a live loop; no other phase an
# archived one): the card tracks every frame and closes 11 archived loops
# from frame 228 on, 0.1353-0.1354 m, in two runs of one call. It is a
# check of the path, not of parity: the JAX facade loses this row at frame
# 208 (its key chain seeded 42) or 78 (seeded 2), so the pass asserts every
# frame tracked and at least one archived loop, and no ATE bound.
PIPE_SCENE_SEED = 7
PIPE_FRAMES = 300
PIPE_WARM = 10
PIPE_DEPTH = 1
PIPE_JAX = dict(n_frames=297, trajectory=298, loops=(0, 0, 3), ate=0.5130,
                keyframes_built=60, evictions=50)
PIPE_ATE_BOUND_M = 0.80
PIPE_LOOP_SCENE_SEED = 42
# the sync audit, a pass of its own after the timed one (so that e2e_fps
# and the frame latencies are read without it): the same row fed up to
# frame PIPE_AUDIT_STOP - 1, every dispatch of its timed frames but a
# relocalised one under torch.cuda.set_sync_debug_mode("error"); at least
# PIPE_AUDIT_MIN dispatches, and as many tracking-only frames
PIPE_AUDIT_STOP = 60
PIPE_AUDIT_MIN = 20
# warm frames whose pinned probe read is held to out.probe.cpu() bit for
# bit: each is dispatched behind a spin kernel of PIPE_SPIN_CYCLES (~0.1 s),
# so its copy is queued behind the spin when a later call retires it
PIPE_PROBE_FRAMES = (5, 6, 7)
PIPE_SPIN_CYCLES = 200_000_000
# readings that later phases print beside their own (phase 7's sequential
# frame latencies beside phase 8's pipelined ones)
READINGS: dict = {}
# Phase 9: the reference's refinement configuration, built by the port's
# config.build_system_config from data/flags/alg_refine.flags (common.flags
# beneath it: reprojection, geometric factors and loop closure on,
# pho_iters 15,15,30, LASTN with 4 back-connections, a window of 16, the
# dense solve) with one command-line override for the synthetic orbit's
# pacing: tracking_dist_threshold 5.0, as every other phase uses. At the
# flags' 2.0, equal to the keyframe distance, a frame that crosses 2.0 is
# lost before it can become a keyframe: the JAX facade loses room 7 at
# frame 8 so. The geometric pool holds max_keyframes *
# max_back_connections + 16 factors (the rep pool's worst-case rule): the
# default of 16 is exhausted at the fifth keyframe event with four
# back-connections, in the JAX package as here. The JAX facade's CPU run
# (port_tools/jax_smoke_reference.py --flagfile data/flags/alg_refine.flags
# --set tracking_dist_threshold=5.0 --frames 100 --scene-seed 7) tracks
# every frame of room 7's first 100: 18 keyframes built, 2 evictions, no
# loop, 54 geo and 75 rep factors live at the end, rigid ATE 0.1948 m.
REFINE_FLAGFILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "flags", "alg_refine.flags")
REFINE_OVERRIDES = ("--tracking_dist_threshold=5.0",)
REFINE_SCENE_SEED = 7
REFINE_FRAMES = 100
REFINE_JAX = dict(ate=0.1948, keyframes_built=18, evictions=2, geo_live=54,
                  rep_live=75, loops=(0, 0, 0))
# above JAX's 0.1948 m, the card's 0.1848 m (two runs) and the port's
# 0.1879 m on a CPU with JAX's draws replayed
REFINE_ATE_BOUND_M = 0.25
# Phase 9a: geometric_system at the path's shapes, card against CPU:
# 16 factors of 128 points, CS 32, 192x256, each block of JtJ and Jtr and
# the error sum within GEO_SYS_TOL of the block's largest entry; the
# validity masks and the nearest-pixel lookups identical but for points
# whose projected pixel lies within GEO_ROUNDOFF_PX of an integer
GEO_FACTORS, GEO_POINTS = 16, 128
GEO_SYS_TOL = 1e-4
GEO_ROUNDOFF_PX = 1e-3
# Phase 9b: tests/test_mapper.py:174's depth-prior scenario at 192x256; the
# decoded depth's mean absolute error to the target falls from 0.5 to
# 0.0712 in the first GN iteration (a factor 7.025) and to 0 when mapped to
# the end, code -0.5555554, on the JAX package's CPU
# (port_tools/jax_smoke_reference.py --depth-prior)
DPRIOR_FACTOR_JAX = 7.025
DPRIOR_FACTOR_TOL = 0.10
DPRIOR_CODE_JAX = -0.5555554
DPRIOR_CODE_TOL = 1e-4
# Phase 10: the demo entry (deepfactors_tpu_torch/demo.run on the card) in
# the reference's dataset configuration, data/flags/dataset_odom.flags
# (alg_odom.flags over common.flags: reprojection factors and loop closure
# on) with room256_32v4, and the orbit's tracking_dist_threshold of 5.0: the
# flags' 2.0 equals the keyframe distance, so a frame is lost before it
# becomes a keyframe (as in phase 9; JAX's demo loses room 7 at frame 6).
# Data are written under build/phase10 (git-ignored) by
# port_tools/demo_data.py on the host CPU. JAX references:
# port_tools/jax_demo_reference.py with the same argv on the CPU.
HERE = os.path.dirname(os.path.abspath(__file__))
DEMO_DIR = os.path.join(HERE, "build", "phase10")
DEMO_FLAGS = (
    "--flagfile", os.path.join(HERE, "data", "flags", "dataset_odom.flags"),
    "--tracking_dist_threshold=5.0",
    "--network_path", os.path.join(HERE, "data", "nets", "room256_32v4.json"),
    "--network_weights", os.path.join(HERE, "data", "nets",
                                      "room256_32v4.pkl"))
# 10a: TUM's layout at 640x480 (room 7's orbit at TUM's default
# intrinsics), remapped to 256x192, 16 frames after the bootstrap (frames
# 2-17). At frame 12's keyframe event every run parts from every other
# one: each direction's RANSAC is won by a hypothesis that repeats a match
# (rank deficient, its null vector decided by rounding), with JAX's own
# draws replayed too (port_tools/ransac_replay.py --demo-source, ROADMAP
# C). What follows is a draw of that lottery in JAX itself: over its key
# seeds 42 and 0-5, JAX's demo reads 0.0655 m (5 keyframes) and 0.2308,
# 0.2382, 0.2248, 0.065, 0.1959, 0.2154 m (4 each); the port on a CPU
# 0.0773 m with its own draws, 0.2331-0.3121 m under seeds 1-3 and 0.3624
# m with JAX's; the card 0.3198 m with its own and 0.0764 m with JAX's
# (two runs each, deterministic; an H100 at 700 W)
DEMO_TUM_FRAMES, DEMO_TUM_LIMIT = 18, 16
DEMO_TUM_JAX = dict(ate=0.0655, keyframes_built=5, tracked=1.0,
                    sha256="2071199cd608b8361589fb831e0ba47179f9885a14330a94"
                           "e9ba6d9d6ef67fa8")
DEMO_TUM_KEYFRAMES = (4, 5)          # built, over JAX's seven key seeds
# own draws: just above the highest reading of JAX's seeds, the port's and
# the card's (0.3624 m)
DEMO_TUM_ATE_BOUND_M = 0.40
# JAX's draws: just above both readings (JAX 0.0655 m, the card 0.0764 m).
# The run past frame 12 rests on rank-deficient hypotheses, so a change
# that moves the card's round-off there may move it within JAX's spread
DEMO_TUM_JAX_DRAWS_ATE_BOUND_M = 0.09
# JAX's keyframes.txt after frame 11 (--frame_limit 10), the last frame
# before the parting: id, t, q (x, y, z, w). The card with JAX's draws
# reads within 3.2e-4 m / 8.4e-5 of it, the port on a CPU 4.0e-4 / 1.04e-4
DEMO_TUM_PARITY_LIMIT = 10
DEMO_TUM_JAX_KF = (
    (0, 0.000200, -0.000284, 0.000001, -0.000262, -0.000234, 0.000025,
     1.000000),
    (1, -0.038454, 0.003526, -0.000025, 0.000445, -0.016937, 0.000048,
     0.999856),
    (2, -0.230682, 0.018257, -0.018740, 0.003060, -0.099178, 0.001673,
     0.995064))
DEMO_TUM_KF_T_TOL, DEMO_TUM_KF_Q_TOL = 2e-3, 5e-4
# frame 12's rep factors in JAX's run ([src, dst, surviving matches]; the
# best well-posed hypothesis of (3, 2) keeps 9 in float64, of (2, 3) 2)
DEMO_TUM_JAX_REP = [[3, 2, 11]]
# 10b: files:// at 320x240, no ground truth. The H100 hosts this script
# runs on have neither png.h nor jpeglib.h (the phase logs what it finds),
# so the port's native loader cannot build there: the Python decoder
# (io/image_io.py) reads the frames. JAX's demo on the same directory
# (a CPU): 24 frames, frame 19 lost, keyframes built at frames 6, 12 and
# 18 (5 with the bootstrap's); the port on a CPU with JAX's draws the same.
# The card with JAX's draws builds at 7, 13, 19 and loses 20: at frame 6
# the keyframe distance reads 1.99974 against the threshold 2.0 (JAX
# 2.00055), the threshold class of ROADMAP C. With its own draws the card
# loses frames 14 and 22 (RANSAC's draws)
DEMO_FILES_SCHEME = "files"
DEMO_FILES_FRAMES, DEMO_FILES_LIMIT = 30, 24
DEMO_FILES_JAX = dict(lost=(19,), keyframe_frames=(6, 12, 18),
                      keyframes_built=5)
# 10c: the synthetic driver at 320x240, rendered on the card; its frames
# within DEMO_RENDER_TOL of the same driver on the CPU. A sample coordinate
# near 320 px holds float32 steps of 3.05e-5 px, and the texture's blobs
# step by up to 0.9 a pixel, so one step of round-off in the warp moves a
# sample by up to ~2.7e-5: the card reads 1.99e-5, over 1e-5, which holds
# at 64x48 (tests/test_torch_drivers.py)
DEMO_SYN = "synthetic://320x240:30"
DEMO_SYN_JAX = dict(ate=0.0691, keyframes_built=3, tracked=1.0)
# just above both readings: JAX 0.0691 m (a CPU), the card 0.0652 m
DEMO_SYN_ATE_BOUND_M = 0.08
DEMO_RENDER_TOL = 3e-5
# 10d: phase 4's configuration on the native C++ scheduler, a Python
# scheduler shadowing it call for call; then the Python scheduler alone.
# The two runs differ by the round-off of assemble's atomics only: phase
# 4's ATE spreads by 1e-3 m over runs of one configuration (PERF.md); the
# card reads 1.2e-4 to 2.9e-4 between the two
NATIVE_ATE_TOL_M = 2e-3
# 10e: checkpoint after the first keyframe event from frame RESUME_FROM of
# 10d's configuration (Python scheduler), restore into a fresh system, go
# on to frame N_FRAMES; every pose after the cut within RESUME_TOL_M of
# 10d's uninterrupted Python run. The restore itself is exact (on the CPU
# the resumed run equals the uninterrupted one, tests/test_torch_checkpoint)
# and the card's runs differ by the atomics' round-off: it reads 7.7e-4 to
# 2.86e-3 m
RESUME_FROM = 20
RESUME_TOL_M = 1e-2

# Phase 11 (decoder training). port_tools/jax_train_reference.py imports
# these constants and helpers (numpy only) and runs the JAX package's
# make_train_step on the same step on a CPU.
# 11a/11b: one step of the recipe (tools/train_room_decoder.py's VAEModel at
# room256_32v4's width: CS 32, 3 levels, base_ch 32, the conv head; clip 1.0
# + adamw under cosine_decay_schedule(3e-4, 36000, alpha=0.1), beta 3e-4,
# distill 0.1) from room256_32v4's decoder and an encoder drawn from
# TRAIN_ENC_SEED, on a batch of 8: one view of each of TRAIN_ROOMS (the
# recipe's plain render at 192x256, poses drawn as its build_dataset draws
# them), eps = jax.random.normal(k, (32,)) per sample, k from
# split(PRNGKey(TRAIN_EPS_SEED), 8) (port_tools/threefry_chain.py).
TRAIN_ROOMS = (1, 2, 3, 4, 5, 6, 8, 9)
TRAIN_POSE_SEED = 12
TRAIN_ENC_SEED = 3
TRAIN_EPS_SEED = 12
TRAIN_HP = dict(lr=3e-4, decay_steps=36000, alpha=0.1, weight_decay=1e-4,
                clip=1.0, beta=3e-4, distill_w=0.1)
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "phase11")
# Limits of 11a (card against CPU) and 11b (card against JAX). Both sides
# compute in bf16 and round at different places (cuDNN / XLA's patch einsum
# / oneDNN); the limits stand over spreads read on a CPU at this step:
# the port against JAX (port_tools/jax_train_reference.py) loss 1.69e-2,
# nll 1.76e-2, kl 1.8e-4, distill 2.4e-3, kernel-gradient norm 2.3e-3,
# modules' kernel-gradient norms <= 1.52e-2, the finest head's bias 1.46e-2;
# and the port's bf16 step against the same step with fp32 convolutions:
# nll 9.2e-3, distill 4.5e-3, gradient norm 3.9e-3, a leaf's gradient
# <= 5.7e-2 (relative L2; ConvBlock_1's, then the first convs), all leaves
# 1.6e-2, Adam's first step apart by more than 0.1 lr at 0.83 percent of
# the elements (each element moves by ~lr x sign(g), so a near-zero
# gradient may flip; never by more than 2 lr). The nll is large here (~90:
# a random encoder's codes move prx against a small learned b), which
# magnifies prx's bf16 noise.
TRAIN_LOSS_TOL = 0.05       # loss, nll: relative
TRAIN_TERM_TOL = 0.02       # kl, distill, gradient norms: relative
TRAIN_LEAF_TOL = 0.15       # a leaf's (or a module's) gradient: relative L2
TRAIN_ALL_TOL = 0.05        # all gradients together: relative L2
TRAIN_FLIP_SHARE = 0.03     # elements whose first Adam step differs
# JAX's step on a CPU (JAX_PLATFORMS=cpu python
# port_tools/jax_train_reference.py, 194 s): the loss and its terms, the
# kernel-gradient norm, each module's kernel-gradient norm, and d loss /
# d bias of the finest head (decoder Conv_7) in forward mode (XLA:CPU sums
# a bf16 cotangent in bf16, so its reverse-mode bias gradients saturate:
# tests/test_torch_train.py).
TRAIN_JAX = dict(
    loss=95.407021, nll=90.960716, kl=0.003053919,
    distill=44.46307, grad_norm_kernels=662.125504,
    kernel_grad_norms={
        "decoder.ConvBlock_0": 310.080788,
        "decoder.ConvBlock_1": 215.520975,
        "decoder.ConvBlock_2": 109.789534,
        "decoder.ConvBlock_3": 51.825423,
        "decoder.ConvBlock_4": 188.215002,
        "decoder.ConvBlock_5": 223.910121,
        "decoder.ConvBlock_6": 197.960391,
        "decoder.Conv_0": 96.542474,
        "decoder.Conv_1": 62.086093,
        "decoder.Conv_2": 38.439098,
        "decoder.Conv_3": 4.627857,
        "decoder.Conv_4": 12.064949,
        "decoder.Conv_5": 183.080706,
        "decoder.Conv_6": 160.731281,
        "decoder.Conv_7": 286.48232,
        "decoder.code_head_conv": 8.629801,
        "encoder.ConvBlock_0": 0.010872,
        "encoder.ConvBlock_1": 0.018573,
        "encoder.ConvBlock_2": 0.073581,
        "encoder.ConvBlock_3": 0.671407,
        "encoder.Conv_0": 0.008878,
        "encoder.Conv_1": 0.015498,
        "encoder.Conv_2": 0.123093,
        "encoder.Conv_3": 1.167765,
        "encoder.Dense_0": 0.995881,
        "encoder.Dense_1": 0.219856},
    finest_head_bias_grad=[
        -50.4497, -28.4061, -1.26669, -1.168, 0.35208, -0.883309,
        -0.787026, 1.1488, -0.0832347, -0.115171, -1.30234, -0.555216,
        0.671439, 1.37896, -0.25159, -0.383044, 0.0289125, 0.570246,
        -1.18288, -1.04773, 1.46668, -1.15975, -0.517935, -3.71297,
        -1.11053, -0.610083, -0.117396, -0.406401, 0.289451, 0.525106,
        0.924566, 0.289026, 0.226858, 1.24171])
# 11c: the recipe (tools/train_room_decoder.py's flags; room256_32v4's head)
# cut to 16 rooms x 16 views and 300 steps; 11d serves its weights in phase
# 4's configuration on the first TRAIN_SERVE_FRAMES frames
TRAIN_RECIPE_STEPS = 300
TRAIN_RECIPE_ARGV = ["--steps", str(TRAIN_RECIPE_STEPS), "--batch", "8",
                     "--rooms", "16", "--val-rooms", "2", "--poses-per-room",
                     "16", "--randomize", "--pred-head", "conv",
                     "--log-every", "50"]
TRAIN_WARM_STEPS = 10
TRAIN_SERVE_FRAMES = 20


# Phase 12 (the tools: deepfactors_tpu_torch/tools), each on the card at
# full width (192x256, room256_32v4, CS 32). The viewers read a run
# directory of phase 4's configuration: LiveViewer attached to its first
# TOOLS_LIVE_FRAMES frames, then save_results. The numbers a tool computes
# are held against the same tool on the CPU: the decoded proximity within
# DECODER_TOL (phase 3's), both solutions of every schur_crossover system
# within TOOLS_SOLVE_TOL (relative L2; the test of the tool against JAX
# holds 1e-4 on a CPU), and voc_test's BoW vectors and scores within
# BOW_SIM_TOL (phase 2b's: the same descriptors give the same words).
TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "phase12")
TOOLS_LIVE_FRAMES = 30
TOOLS_MATCH_SOURCE = "synthetic://256x192:5:0.02"
TOOLS_VOC_SOURCE = "synthetic://256x192:40"
TOOLS_SOLVE_TOL = 1e-4

# Phase 13 (several ranks: parallel/multihost, tools/multihost_demo, the
# dry-run matrix, scene-split odometry, data-parallel training). A world of
# n ranks runs NCCL with a card a rank where the machine has n cards, else
# gloo with every rank on cuda:0 (NCCL refuses two ranks on one card).
MULTI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "phase13")
MULTI_TIMEOUT_S = 300
# JAX's digest of the same demo (tools/multihost_demo.py: 2 processes x 2
# CPU devices, 8 factors at 192x256, CS 32, 3 steps; sum |pose_t|, the
# last step's inliers), from `JAX_PLATFORMS=cpu python
# tools/multihost_demo.py` on a CPU (the card has no JAX). The port's
# digests are held to it and to one process within MULTI_DEMO_TOL: the
# sum absolutely (the BA tolerance of tests/test_torch_parallel.py), the
# inlier count relatively.
MULTI_DEMO_JAX = (0.02116625, 385904.0)
MULTI_DEMO_TOL = 1e-4
MULTI_DRYRUN_WORLDS = (1, 2, 4)
# 13b: world 1 (a process of its own) against 6a's dryrun_single here. Not
# bit for bit: the assembly's index_put_(accumulate=True) / index_add_ sum
# with float atomics on the card, so two runs in one process differ at
# round-off too (on an NVIDIA H100 80GB HBM3, 700 W, world 1 read
# 7.6e-9-1.9e-8 from it, two runs in one process 0-2.4e-9)
MULTI_SAME_TOL = 1e-6
# 13d: the poses of 2 ranks x 4 rooms against 6c's one process. Each rank
# launches se3_gram_batch at P = 4 with the plan of P = 8 (plan_p): with its
# own plan (3 pixels a thread at 192x256 against 6) a scene's sums ran in
# another order and the poses drifted 1.6e-6 from one process over 30
# frames (13d on an NVIDIA H100 80GB HBM3, 700 W)
MULTI_ODO_TOL = 1e-6
# 13e: 11a's step over 2 ranks of 4 rows against one process of 8, at the
# limits of tests/test_torch_multihost.py, set over the spread it reads on
# a CPU (in brackets): loss, nll, kl, distill relative 1e-5 (7.5e-8); the
# gradient norm relative 5e-3 (6.6e-4), a leaf's gradient 1e-2 (2.55e-3)
# and all together 5e-3 (1.6e-3) relative L2: a bf16 convolution's weight
# gradient comes out rounded to bf16 (2^-9 relative) once per rank; the
# parameters after the update within 2 lr. Apart by more than 0.1 lr (Adam's
# first step is ~lr x sign(g), so a gradient element near 0 may flip): at
# no more than 2e-3 of the elements, between this step's sound readings
# (5.3e-4 on a CPU, 5.5e-4 on an NVIDIA H100 80GB HBM3, 700 W) and a
# planted fault, a rank stepping on its own 4 rows with no reduce (0.169
# and 0.180 of the elements for the two halves, on a CPU).
MULTI_TRAIN_TERM_TOL = 1e-5
MULTI_TRAIN_NORM_TOL = 5e-3
MULTI_TRAIN_LEAF_TOL = 1e-2
MULTI_TRAIN_ALL_TOL = 5e-3
MULTI_TRAIN_FLIP_SHARE = 2e-3
MULTI_RECIPE_STEPS = 50
MULTI_RECIPE_ARGV = (["--steps", str(MULTI_RECIPE_STEPS)]
                     + TRAIN_RECIPE_ARGV[2:])


def train_batch_poses():
    """[8, 4] quaternions and [8, 3] positions, one per TRAIN_ROOMS entry,
    drawn as the recipe's build_dataset draws a pose (radius <= 1.2)."""
    rng = np.random.RandomState(TRAIN_POSE_SEED)
    qs, ts = [], []
    for _ in TRAIN_ROOMS:
        r, th = rng.uniform(0.0, 1.2), rng.uniform(0, 2 * np.pi)
        ts.append([r * np.cos(th), rng.uniform(-0.25, 0.25), r * np.sin(th)])
        yaw, pitch = rng.uniform(0, 2 * np.pi), rng.uniform(-0.25, 0.25)
        cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
        cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
        qs.append([cy * cp, cy * sp, sy * cp, -sy * sp])
    return np.asarray(qs, np.float32), np.asarray(ts, np.float32)


def encoder_tree(code_size=32, base_ch=32, seed=TRAIN_ENC_SEED):
    """The JAX DepthEncoder's parameter tree (numpy float32): kernels a
    unit normal clipped at 2, over sqrt(fan_in); biases 0.01 x normal."""
    rng = np.random.RandomState(seed)

    def conv(cin, cout):
        k = np.clip(rng.standard_normal((3, 3, cin, cout)), -2, 2)
        return {"kernel": (k / np.sqrt(9 * cin)).astype(np.float32),
                "bias": (0.01 * rng.standard_normal(cout)).astype(np.float32)}

    tree, ch, cin = {}, base_ch, 2
    for i in range(4):
        nxt = min(ch * 2, 4 * base_ch)
        tree[f"ConvBlock_{i}"] = {"Conv_0": conv(cin, ch),
                                  "Conv_1": conv(ch, ch)}
        tree[f"Conv_{i}"] = conv(ch, nxt)
        cin = ch = nxt
    for i in range(2):
        k = np.clip(rng.standard_normal((ch, code_size)), -2, 2)
        tree[f"Dense_{i}"] = {
            "kernel": (k / np.sqrt(ch)).astype(np.float32),
            "bias": (0.01 * rng.standard_normal(code_size)).astype(np.float32)}
    return tree


def grad_groups(names):
    """Parameter names (a VAEModel state_dict's) grouped by their module
    under decoder / encoder: ``decoder.ConvBlock_0`` holds both convs'
    kernels. Bias leaves are left out (see TRAIN_JAX)."""
    groups = {}
    for n in names:
        if n.endswith("bias"):
            continue
        groups.setdefault(".".join(n.split(".")[:2]), []).append(n)
    return groups


def large_map_links():
    c = LARGE
    return [(j, i) for i in range(c["K"])
            for j in range(max(0, i - c["back"]), i)]


def large_map_noise():
    """[K, 6] tangent perturbation of the large map's poses, seeded."""
    c = LARGE
    rng = np.random.RandomState(c["noise_seed"])
    d = np.concatenate([c["noise"][0] * rng.standard_normal((c["K"], 3)),
                        c["noise"][1] * rng.standard_normal((c["K"], 3))],
                       axis=1).astype(np.float32)
    d[0] = 0.0
    return d


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def start_variant_build(src, lib):
    """Start nvcc on a source outside csrc/ (an earlier design, timed beside
    a kernel) with the port's flags and csrc/ on the include path; returns
    the running process."""
    from deepfactors_tpu_torch.ops.kernels import build
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib,
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_variant_build(proc, lib, fn, nptr, nint):
    """Wait for ``start_variant_build``'s nvcc and return the C function
    ``fn`` of the library (nptr pointers, nint ints, then the stream)."""
    import ctypes
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib}:\n{text}")
    f = getattr(ctypes.CDLL(lib), fn)
    f.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def cuda_ms(fn, iters=20, warmup=3, spin_cycles=100_000_000):
    """Device milliseconds per call of ``fn``: CUDA events around ``iters``
    back-to-back calls. A spin kernel (~50 ms at the default
    ``spin_cycles``) is queued first, so the host has enqueued every call
    before the first one starts and the events time the device's work, not
    the Python wrapper's launch rate; a caller whose calls take the host
    longer to enqueue than the spin lasts passes a longer spin."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3


def bound(nbytes, flops):
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ----------------------------------------------------------------------------
# phase 2: kernels vs plain twins
# ----------------------------------------------------------------------------

def make_pools(dev, K=32, CS=32, seed=0):
    """Keyframe pools of a real scene: rendered room views (images, Sobel
    planes, depth), a random small code Jacobian and codes, the true
    camera-to-world poses."""
    import torch
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.ops import image as ip

    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    scene = synth.random_room(3, n_boxes=3)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)[:K]
    g = torch.Generator(device="cpu").manual_seed(seed)
    imgs, dpts = [], []
    for p in poses:
        im, dp = synth.render_aa(scene, cam, p, H, W, device=dev)
        imgs.append(im)
        dpts.append(dp)
    img = torch.stack(imgs)
    dpt = torch.stack(dpts)
    levels = []
    for l in range(3):
        if l:
            img = ip.gaussian_blur_down(img)
            dpt = ip.gaussian_blur_down(dpt)
        grad = ip.sobel_gradients(img)
        jac = (0.01 * torch.randn((K, CS) + img.shape[1:], generator=g)).to(dev)
        levels.append(dict(img=img.contiguous(), dpt=dpt.contiguous(),
                           gx=grad[..., 0].contiguous(),
                           gy=grad[..., 1].contiguous(), jac=jac))
    q = torch.tensor(np.stack([p.q for p in poses]), device=dev)
    t = torch.tensor(np.stack([p.t for p in poses]), device=dev)
    codes = (0.1 * torch.randn((K, CS), generator=g)).to(dev)
    return cam, levels, q, t, codes


def factor_set(K, P, dev, seed=1):
    import torch
    rng = np.random.RandomState(seed)
    src = rng.randint(0, K, P)
    dst = np.clip(src + rng.choice([-2, -1, 1, 2], P), 0, K - 1)
    dst = np.where(dst == src, (src + 1) % K, dst)
    active = np.zeros(P, np.int32)
    active[rng.permutation(P)[:P // 2]] = 1
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return t(src), t(dst), t(active)


def perturb(pose, seed):
    """pose (batched [P]) moved off by POSE_NOISE, seeded."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    rng = np.random.RandomState(seed)
    P = pose.t.shape[0]
    d = np.concatenate([POSE_NOISE[0] * rng.standard_normal((P, 3)),
                        POSE_NOISE[1] * rng.standard_normal((P, 3))], axis=1)
    return se3m.retract(pose, torch.tensor(d, dtype=torch.float32,
                                           device=pose.t.device))


def block_errs(Gk, Gp, DB):
    """Kernel vs twin by block of G, each on its own per-factor scale:
    {jtj, jtr, res (relative errors), inl (max abs diff of the inlier
    count), g (relative to max|G|, all of G), abs (max abs diff over G)}."""
    def rel(a, b):
        d = (a - b).abs().flatten(1).max(dim=1).values
        s = b.abs().flatten(1).max(dim=1).values.clamp(min=1e-12)
        return float((d / s).max())
    return dict(jtj=rel(Gk[:, :DB, :DB], Gp[:, :DB, :DB]),
                jtr=rel(Gk[:, :DB, DB], Gp[:, :DB, DB]),
                res=rel(Gk[:, DB, DB, None], Gp[:, DB, DB, None]),
                inl=float((Gk[:, DB + 1, DB + 1] - Gp[:, DB + 1, DB + 1])
                          .abs().max()),
                g=rel(Gk, Gp), abs=float((Gk - Gp).abs().max()))


def phase_kernels(dev, first_design=None):
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import camera_pyramid
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.geometry.warping import depth_to_prox
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    K = 32
    cam, levels, q, t, codes_k = make_pools(dev, K=K, CS=32)
    cams = camera_pyramid(cam, 3)
    results = {}
    worst = {n: dict.fromkeys(("jtj", "jtr", "res", "inl", "g", "abs"), 0.0)
             for n in ("se3_gram_batch", "sfm_gram_batch")}
    # the floor under any single launch: a kernel that does nothing
    empty_ms = cuda_ms(lambda: sg.empty_launch(dev), iters=200)
    log(f"empty launch: {empty_ms:.5f} ms a launch (the floor of a "
        f"one-launch kernel on this card)")

    def record(name, errs, Gp, DB):
        w = worst[name]
        for k, v in errs.items():
            w[k] = max(w[k], v)
        on = Gp[:, DB + 1, DB + 1] > 0
        assert bool((Gp[on, :DB, DB].abs().amax(dim=1) > 0).all()), \
            f"{name}: an active factor has Jtr = 0"
        assert errs["inl"] == 0, f"{name}: inlier counts differ: {errs}"
        for k in ("jtj", "jtr", "res"):
            assert errs[k] < KERNEL_TOL, f"{name}: {k} rel err {errs} >= {KERNEL_TOL}"

    def summary(name, n):
        w = worst[name]
        log(f"{name}: {n} checks, max rel err JtJ {w['jtj']:.3e}, Jtr "
            f"{w['jtr']:.3e}, residual {w['res']:.3e} (tol {KERNEL_TOL}); "
            f"inlier counts equal; of max|G| {w['g']:.3e}, max abs err "
            f"{w['abs']:.3e}")

    # --- sfm_gram_batch --------------------------------------------------
    P = 128
    src, dst, active = factor_set(K, P, dev)
    sl, dl = src.long(), dst.long()
    pose_10, _, _ = se3m.relative_pose_jacobians(SE3(q[dl], t[dl]),
                                                 SE3(q[sl], t[sl]))
    pose_10 = perturb(pose_10, seed=3)
    n_checks = 0
    for l, lv in enumerate(levels):
        for CS in (32, 8):
            jac = lv["jac"][:, :CS].contiguous()
            codes = codes_k[:, :CS][sl].contiguous()
            # prx0 such that prx0 + jac·code reproduces the rendered depth
            prx = depth_to_prox(lv["dpt"], 2.0)
            prx0 = (prx - torch.einsum("kchw,kc->khw", jac, codes_k[:, :CS])).contiguous()
            for loss in ("huber", "tukey"):
                kp = sg.make_sfm_params(pose_10, cams[l], 2, 0.0,
                                        0.1 if loss == "tukey" else 0.3, 2.0)
                for from_prox in (False, True):
                    for gm in ("interp", "sampled"):
                        args = (kp, src, dst, lv["img"],
                                prx0 if from_prox else lv["dpt"], jac,
                                lv["img"], lv["gx"], lv["gy"])
                        kw = dict(active=active,
                                  codes=codes if from_prox else None,
                                  grad_mode=gm, loss=loss)
                        Gk = sg.sfm_gram_batch(*args, **kw)
                        Gp = sg.sfm_gram_batch_plain(*args, **kw)
                        torch.cuda.synchronize()
                        assert torch.isfinite(Gk).all()
                        assert (Gk[active == 0] == 0).all()
                        record("sfm_gram_batch",
                               block_errs(Gk, Gp, 6 + CS), Gp, 6 + CS)
                        n_checks += 1
                        # the main path: CS 32, depth from the codes,
                        # interp gradients, Tukey at level 0, Huber above
                        main = (CS == 32 and from_prox and gm == "interp"
                                and loss == ("tukey" if l == 0 else "huber"))
                        if main:
                            ms_k = cuda_ms(lambda: sg.sfm_gram_batch(*args, **kw))
                            ms_p = cuda_ms(lambda: sg.sfm_gram_batch_plain(*args, **kw),
                                           iters=5)
                            R = CS + 8
                            N = lv["img"].shape[1] * lv["img"].shape[2]
                            on = active.bool()
                            n_src = len(set(src[on].tolist()))
                            n_dst = len(set(dst[on].tolist()))
                            inl = float(Gp[on, R - 1, R - 1].sum())
                            nbytes = (n_src * (2 + CS) * N * 4 + n_dst * N * 4
                                      + P * (sg.PARAM_DIM + CS + 3) * 4
                                      + P * R * R * 4)
                            flops = inl * (R * (R + 1) + 2 * CS + 160)
                            bms, by = bound(nbytes, flops)
                            hw = "x".join(map(str, lv["img"].shape[1:]))
                            results.setdefault("sfm_gram_batch", []).append(dict(
                                ms=ms_k, plain_ms=ms_p, bound_ms=bms,
                                first_design=PREV_MS["sfm_gram_batch"][l],
                                bound_by=by, shape=f"P={P} ({int(on.sum())} active) "
                                f"CS={CS} {hw} {loss} from-prox interp"))
    summary("sfm_gram_batch", n_checks)

    # --- se3_gram_batch --------------------------------------------------
    n_checks = 0
    p8_sampled = []
    for P in (1, 8):
        src, dst, _ = factor_set(K, P, dev, seed=2)
        active = torch.ones(P, dtype=torch.int32, device=dev)
        sl, dl = src.long(), dst.long()
        pose_10 = perturb(se3m.relative_pose(SE3(q[dl], t[dl]),
                                             SE3(q[sl], t[sl])), seed=4 + P)
        for l, lv in enumerate(levels):
            kp = sg.make_sfm_params(pose_10, cams[l], 1, 0.0, 0.3, 2.0)
            for gm in ("interp", "sampled"):
                args = (kp, src, dst, lv["img"], lv["dpt"], lv["img"],
                        lv["gx"], lv["gy"])
                kw = dict(active=active, grad_mode=gm)
                Gk = sg.se3_gram_batch(*args, **kw)
                Gp = sg.se3_gram_batch_plain(*args, **kw)
                torch.cuda.synchronize()
                assert torch.isfinite(Gk).all()
                record("se3_gram_batch", block_errs(Gk, Gp, 6), Gp, 6)
                n_checks += 1
                if P == 1 and gm == "interp":
                    ms_k = cuda_ms(lambda: sg.se3_gram_batch(*args, **kw), iters=100)
                    ms_p = cuda_ms(lambda: sg.se3_gram_batch_plain(*args, **kw))
                    N = lv["img"].shape[1] * lv["img"].shape[2]
                    inl = float(Gp[0, 7, 7])
                    nbytes = 3 * N * 4 + (sg.PARAM_DIM + 3) * 4 + 64 * 4
                    flops = inl * (72 + 90)
                    bms, by = bound(nbytes, flops)
                    hw = "x".join(map(str, lv["img"].shape[1:]))
                    results.setdefault("se3_gram_batch", []).append(dict(
                        ms=ms_k, plain_ms=ms_p, bound_ms=bms, bound_by=by,
                        first_design=PREV_MS["se3_gram_batch"][l],
                        shape=f"P=1 {hw} interp"))
                if P == 8 and gm == "sampled":
                    # the multi-scene odometry's shape: one factor a scene
                    N = lv["img"].shape[1] * lv["img"].shape[2]
                    planes = (2 * len(set(src.tolist()))
                              + 3 * len(set(dst.tolist())))
                    bms, by = bound(planes * N * 4 + P * (sg.PARAM_DIM + 3 + 64) * 4,
                                    float(Gp[:, 7, 7].sum()) * (72 + 90))
                    hw = "x".join(map(str, lv["img"].shape[1:]))
                    p8_sampled.append(dict(
                        ms=cuda_ms(lambda: sg.se3_gram_batch(*args, **kw), iters=100),
                        plain_ms=cuda_ms(lambda: sg.se3_gram_batch_plain(*args, **kw)),
                        bound_ms=bms, bound_by=by,
                        first_design=PREV_MS["se3_gram_batch_p8_sampled"][l],
                        shape=f"P=8 {hw} sampled"))
    summary("se3_gram_batch", n_checks)
    n_extra = gram_edge_checks(dev, K, cams, levels, q, t, record)
    log(f"Gram kernels, edge cases: {n_extra} more checks against the twins "
        f"at {ODD_HW[0]}x{ODD_HW[1]} (CS 64, 32, 8) and "
        f"{ODD_HW_UNALIGNED[0]}x{ODD_HW_UNALIGNED[1]} (CS 32, 5), at the "
        f"mapper's batch sizes P = {MAPPER_BUCKETS}, tracking batches "
        f"P = {SE3_EXTRA_P} and the loop paths' P = {LOOP_PS} (candidates "
        f"in a pool of their own, one current frame, interp) at the three "
        f"levels, P = 1, all "
        f"factors inactive (G exactly 0); no active bit-identical to all "
        f"active at P = 1 and 128; repeated launches bit-identical, also "
        f"after a launch at another P and size")
    timed = ([("se3_gram_batch", r) for r in p8_sampled]
             + [(name, r) for name, v in results.items() for r in v])
    for name, r in timed:
        # the constant leaves the row here: every number of the kernels line
        # but the bound is one this run measured
        log(f"{name} at {r['shape']}: kernel {r['ms']:.4f} ms (first design "
            f"{r.pop('first_design'):.4f} ms, a constant from an earlier "
            f"run), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} "
            f"ms ({r['bound_by']})")
    # the kernels line reports the finest level, where the main path spends
    # most of each kernel's time
    out = {name: dict(per_level[0]) for name, per_level in results.items()}
    for name, r in out.items():
        w = worst[name]
        r["max_abs_err"] = w["abs"]
        r["max_rel_err"] = {k: w[k] for k in ("jtj", "jtr", "res", "g")}
    out["se3_gram_batch"]["p8_sampled"] = p8_sampled
    out["se3_gram_batch"]["loop_ps"] = loop_gram_times(dev, K, cams, levels,
                                                        q, t)
    out["se3_gram_batch"]["empty_launch_ms"] = empty_ms
    for name, per_level in results.items():
        out[name]["by_level"] = per_level
    out.update(phase_error_kernels(dev, K, cams, levels, q, t, empty_ms))
    out.update(phase_warp_kernels(dev, K, cams, levels, q, t, empty_ms,
                                  first_design))
    out.update(phase_jacobian_stack(dev, K, cam, levels[0], q, t, codes_k))
    return out


def loop_gram_case(dev, K, P, planes, cam, q, t):
    """(args, kw) of se3_gram_batch as the loop paths call it: P candidates
    (keyframes of the pool, repeated past K) in a pool of their own, src =
    arange(P), one current frame (keyframe 5) in a pool of one, dst = 0,
    interp gradients; each candidate's pose to the current frame
    perturbed."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    idx = torch.arange(P, device=dev) % K
    cur = SE3(q[5:6].expand(P, 4), t[5:6].expand(P, 3))
    pose = perturb(se3m.relative_pose(cur, SE3(q[idx], t[idx])), seed=20 + P)
    kp = sg.make_sfm_params(pose, cam, 1, 0.0, 0.3, 2.0)
    src = torch.arange(P, dtype=torch.int32, device=dev)
    dst = torch.zeros(P, dtype=torch.int32, device=dev)
    return ((kp, src, dst, planes["img"][idx].contiguous(),
             planes["dpt"][idx].contiguous(), planes["img"][5:6], None, None),
            dict(active=torch.ones(P, dtype=torch.int32, device=dev),
                 grad_mode="interp"))


def loop_gram_times(dev, K, cams, levels, q, t):
    """se3_gram_batch at the loop paths' P on the finest level: kernel,
    twin and bound, one row a P."""
    import torch
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    rows = []
    for P in LOOP_PS:
        args, kw = loop_gram_case(dev, K, P, levels[0], cams[0], q, t)
        kw = dict(kw, active=None)       # as the loop paths call it
        Gp = sg.se3_gram_batch_plain(*args, **kw)
        N = H * W
        # P candidate images and depths and the current image read once;
        # params in, G out
        bms, by = bound((2 * P + 1) * N * 4 + P * (sg.PARAM_DIM + 64) * 4,
                        float(Gp[:, 7, 7].sum()) * (72 + 90))
        rows.append(dict(
            ms=cuda_ms(lambda: sg.se3_gram_batch(*args, **kw), iters=50),
            plain_ms=cuda_ms(lambda: sg.se3_gram_batch_plain(*args, **kw),
                             iters=5),
            bound_ms=bms, bound_by=by, shape=f"P={P} {H}x{W} interp, loop"))
    for r in rows:
        log(f"se3_gram_batch at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    torch.cuda.synchronize()
    return rows


def gram_edge_checks(dev, K, cams, levels, q, t, record):
    """The two Gram kernels where a tiling or a ticket could go wrong: planes
    cropped to ODD_HW and ODD_HW_UNALIGNED (no multiple of the pixel tile in
    either direction) with CS 64, 32, 8 and 5; P = 1; every factor
    inactive; three launches on the same inputs, and one after a launch at
    another P and size, must give the same bits (a ticket that was not reset
    would not). Returns the number of kernel-vs-twin checks."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.geometry.warping import depth_to_prox
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    def cropped(hw):
        return {k: levels[1][k][:, :hw[0], :hw[1]].contiguous()
                for k in ("img", "dpt", "gx", "gy")}

    crop, crop_u = cropped(ODD_HW), cropped(ODD_HW_UNALIGNED)
    g = torch.Generator(device="cpu").manual_seed(7)
    n = 0

    def factors(P, seed, noise_seed, jacobians):
        src, dst, active = factor_set(K, P, dev, seed=seed)
        sl, dl = src.long(), dst.long()
        a, b = SE3(q[dl], t[dl]), SE3(q[sl], t[sl])
        pose = (se3m.relative_pose_jacobians(a, b)[0] if jacobians
                else se3m.relative_pose(a, b))
        return src, dst, active, perturb(pose, seed=noise_seed)

    def sfm_case(P, planes, cam, CS, loss, gm, from_prox, active=None):
        """(args, kw) of one sfm_gram_batch call on ``planes``."""
        src, dst, act, pose = factors(P, 1, 3, True)
        jac = (0.01 * torch.randn((K, CS) + planes["img"].shape[1:],
                                  generator=g)).to(dev)
        codes_k = (0.1 * torch.randn((K, CS), generator=g)).to(dev)
        prx0 = (depth_to_prox(planes["dpt"], 2.0)
                - torch.einsum("kchw,kc->khw", jac, codes_k)).contiguous()
        kp = sg.make_sfm_params(pose, cam, 2, 0.0,
                                0.1 if loss == "tukey" else 0.3, 2.0)
        args = (kp, src, dst, planes["img"],
                prx0 if from_prox else planes["dpt"], jac, planes["img"],
                planes["gx"], planes["gy"])
        kw = dict(active=act if active is None else active,
                  codes=codes_k[src.long()].contiguous() if from_prox else None,
                  grad_mode=gm, loss=loss)
        return args, kw

    def se3_case(P, planes, cam, gm, active=None):
        src, dst, _, pose = factors(P, 2, 4 + P, False)
        kp = sg.make_sfm_params(pose, cam, 1, 0.0, 0.3, 2.0)
        if active is None:
            active = torch.ones(P, dtype=torch.int32, device=dev)
        return ((kp, src, dst, planes["img"], planes["dpt"], planes["img"],
                 planes["gx"], planes["gy"]), dict(active=active, grad_mode=gm))

    def against_twin(name, args, kw, DB):
        kernel, twin = ((sg.sfm_gram_batch, sg.sfm_gram_batch_plain)
                        if name == "sfm_gram_batch" else
                        (sg.se3_gram_batch, sg.se3_gram_batch_plain))
        Gk, Gp = kernel(*args, **kw), twin(*args, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(Gk).all(), name
        assert bool((Gk[kw["active"] == 0] == 0).all()), \
            f"{name}: an inactive factor is not zero"
        assert torch.equal(Gk, Gk.transpose(1, 2)), f"{name}: G not symmetric"
        record(name, block_errs(Gk, Gp, DB), Gp, DB)
        return Gk

    # a size that no tile divides, three code sizes
    for CS in (64, 32, 8):
        for loss, gm, from_prox in (("huber", "interp", True),
                                    ("tukey", "sampled", False)):
            args, kw = sfm_case(128, crop, cams[1], CS, loss, gm, from_prox)
            against_twin("sfm_gram_batch", args, kw, 6 + CS)
            n += 1
    args, kw = sfm_case(128, crop_u, cams[1], 32, "huber", "interp", True)
    against_twin("sfm_gram_batch", args, kw, 38)
    args, kw = sfm_case(128, crop_u, cams[1], 5, "tukey", "sampled", False)
    against_twin("sfm_gram_batch", args, kw, 11)
    n += 2
    for P in (1, 8):
        for gm in ("interp", "sampled"):
            against_twin("se3_gram_batch", *se3_case(P, crop, cams[1], gm), 6)
            n += 1
    against_twin("se3_gram_batch", *se3_case(8, crop_u, cams[1], "sampled"), 6)
    n += 1
    # the batch sizes the mapper's buckets give sfm_gram_batch on the main
    # paths besides 128 (8 and 64 with a pool of 128 factors; 8, 32 and 64
    # with the long run's pool of 64): each has a strip plan of its own
    for P in MAPPER_BUCKETS:
        for l, lv in enumerate(levels):
            args, kw = sfm_case(P, lv, cams[l], 32,
                                "tukey" if l == 0 else "huber", "interp", True)
            against_twin("sfm_gram_batch", args, kw, 38)
            n += 1
    # se3_gram_batch with 1, 2, 3, 6 and 8 pixels a thread: the batch sizes
    # between one factor and more scenes than the odometry's eight
    for P in SE3_EXTRA_P:
        for l, lv in enumerate(levels):
            against_twin("se3_gram_batch", *se3_case(P, lv, cams[l], "sampled"), 6)
            n += 1
    # the loop paths' batches: verification and relocalisation, each with
    # a strip plan of its own
    for P in LOOP_PS:
        for l, lv in enumerate(levels):
            against_twin("se3_gram_batch",
                         *loop_gram_case(dev, K, P, lv, cams[l], q, t), 6)
            n += 1
    # one factor; every factor inactive
    args, kw = sfm_case(1, levels[0], cams[0], 32, "tukey", "interp", True,
                        active=torch.ones(1, dtype=torch.int32, device=dev))
    against_twin("sfm_gram_batch", args, kw, 38)
    n += 1
    off = lambda P: torch.zeros(P, dtype=torch.int32, device=dev)
    args, kw = sfm_case(128, levels[0], cams[0], 32, "huber", "interp", True,
                        active=off(128))
    G0 = sg.sfm_gram_batch(*args, **kw)
    args8, kw8 = se3_case(8, levels[0], cams[0], "sampled", active=off(8))
    G8 = sg.se3_gram_batch(*args8, **kw8)
    torch.cuda.synchronize()
    assert bool((G0 == 0).all()) and bool((G8 == 0).all()), \
        "all factors inactive: G is not zero"
    assert bool((sg.sfm_gram_batch_plain(*args, **kw) == 0).all())
    # no active (null in the kernel) is every factor active: the same bits
    # as an explicit all-ones active
    on = lambda P: torch.ones(P, dtype=torch.int32, device=dev)
    for P in (1, 128):
        for name, fn, (a_, kw_) in (
                ("sfm_gram_batch", sg.sfm_gram_batch,
                 sfm_case(P, levels[0], cams[0], 32, "tukey", "interp", True,
                          active=on(P))),
                ("se3_gram_batch", sg.se3_gram_batch,
                 se3_case(P, levels[0], cams[0], "sampled", active=on(P)))):
            G_on = fn(*a_, **kw_)
            G_none = fn(*a_, **dict(kw_, active=None))
            torch.cuda.synchronize()
            assert torch.equal(G_none, G_on), \
                f"{name}: no active differs from all active at P = {P}"
    # repeated launches: the same bits, also after another P and size
    main_sfm = sfm_case(128, levels[0], cams[0], 32, "tukey", "interp", True)
    odd_sfm = sfm_case(1, crop, cams[1], 8, "huber", "sampled", False,
                       active=torch.ones(1, dtype=torch.int32, device=dev))
    main_se3 = se3_case(1, levels[0], cams[0], "interp")
    odd_se3 = se3_case(8, crop, cams[1], "sampled")
    for name, fn, main, odd in (
            ("sfm_gram_batch", sg.sfm_gram_batch, main_sfm, odd_sfm),
            ("se3_gram_batch", sg.se3_gram_batch, main_se3, odd_se3)):
        first = fn(*main[0], **main[1])
        for _ in range(2):
            assert torch.equal(fn(*main[0], **main[1]), first), \
                f"{name}: two launches on the same inputs differ"
        other = fn(*odd[0], **odd[1])
        assert torch.equal(fn(*main[0], **main[1]), first), \
            f"{name}: differs after a launch at another P and size"
        assert torch.equal(fn(*odd[0], **odd[1]), other), name
    torch.cuda.synchronize()
    return n


def error_plan_ps(H, W, p_max=128):
    """The smallest P of every distinct launch plan that P = 1..p_max gives
    sfm_error_batch and se3_warp_batch (one plan rule for both) on H x W
    planes: the dump's P is the number of live factors at a level,
    anywhere from 1 to max_factors (128 in phase 4)."""
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg
    first = {}
    for P in range(1, p_max + 1):
        plan = sg.launch_plan("sfm_error_batch", P, H, W)
        first.setdefault((plan.px_per_blk, plan.nblk), P)
    return sorted(first.values())


def error_case(dev, K, P, planes, cam, q, t):
    """(args, active) of one sfm_error_batch / se3_warp_batch call on
    ``planes`` (img, dpt [K, H, W]) with P factors at perturbed poses: all
    active for P <= 2, else half the slots."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg
    src, dst, active = factor_set(K, P, dev, seed=10 + P)
    if P <= 2:
        active = torch.ones(P, dtype=torch.int32, device=dev)
    sl, dl = src.long(), dst.long()
    pose_10 = perturb(se3m.relative_pose(SE3(q[dl], t[dl]),
                                         SE3(q[sl], t[sl])), seed=20 + P)
    kp = sg.make_sfm_params(pose_10, cam, 1, 0.0, 0.3, 2.0)
    return (kp, src, dst, planes["img"], planes["dpt"], planes["img"]), active


def gate_case(dev, lv, cam, q, t):
    """The keyframe gate's call (P = 2): both depth hypotheses of the new
    keyframe (keyframe 0's image, its depth and 1.05 times it) against the
    newest keyframe's image, on one level ``lv``."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg
    two = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    zero2 = torch.zeros(2, dtype=torch.int32, device=dev)
    pose_10 = perturb(se3m.relative_pose(SE3(q[1:2], t[1:2]),
                                         SE3(q[0:1], t[0:1])), seed=31)
    kp = sg.make_sfm_params(SE3(pose_10.q.expand(2, 4), pose_10.t.expand(2, 3)),
                            cam, 1, 0.0, 0.3, 2.0)
    return (kp, two, zero2, lv["img"][0].expand(2, -1, -1).contiguous(),
            torch.stack([lv["dpt"][0], 1.05 * lv["dpt"][0]]),
            lv["img"][1:2].contiguous())


def phase_error_kernels(dev, K, cams, levels, q, t, empty_ms):
    """sfm_error_batch and se3_warp_batch against their twins at perturbed
    poses: at one P for every distinct launch plan of P = 1..128 (and P =
    1, 2, 64) at the three pyramid sizes and at ODD_HW and
    ODD_HW_UNALIGNED; with every factor inactive (outputs and render
    exactly 0, written over NaN); launched repeatedly (the same bits, also
    after a launch at another P and size, and with ``active`` left out, as
    the main path's callers leave it). Then their times at the shapes
    the main path gives them, beside an empty launch: the keyframe gate
    (P = 2: two depth hypotheses of one image against one reference), the
    map dump (P = 64, half the slots live) and one warp render (P = 1)."""
    import torch
    from deepfactors_tpu_torch.ops.kernels import sfm_error as se
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    worst = {n: dict(res=0.0, abs=0.0) for n in se.LAUNCHES}
    n_checks = 0
    timed = {n: [] for n in se.LAUNCHES}

    def bound_of(args, active, writes_plane):
        """Least bytes: every distinct source plane pair (img0, dpt) and
        target plane of an active factor read once, the params rows, the
        outputs written once; ~50 flops per pixel of an active factor."""
        kp, src, dst, img0 = args[:4]
        N = img0.shape[1] * img0.shape[2]
        on = active.bool()
        P, n_on = src.shape[0], int(on.sum())
        planes = (2 * len(set(src[on].tolist())) + len(set(dst[on].tolist()))
                  + (P if writes_plane else 0))
        nbytes = planes * N * 4 + P * (sg.PARAM_DIM + 3 + 2) * 4
        return bound(nbytes, n_on * N * 50)

    case = lambda P, planes, cam: error_case(dev, K, P, planes, cam, q, t)

    def check(args, active):
        """Both kernels against their twins on one call's inputs."""
        nonlocal n_checks
        rk, ik = se.sfm_error_batch(*args, active=active)
        rp, ip_ = se.sfm_error_batch_plain(*args, active=active)
        wk, rwk, iwk = se.se3_warp_batch(*args, active=active)
        wp_, rwp, iwp = se.se3_warp_batch_plain(*args, active=active)
        torch.cuda.synchronize()
        off = active == 0
        for name, (a_res, a_inl, b_res, b_inl) in (
                ("sfm_error_batch", (rk, ik, rp, ip_)),
                ("se3_warp_batch", (rwk, iwk, rwp, iwp))):
            assert torch.isfinite(a_res).all(), name
            assert torch.equal(a_inl, b_inl), f"{name}: inliers differ"
            seen = b_inl > 0
            assert bool(seen[~off].float().mean() >= 0.5), \
                f"{name}: most active factors saw nothing"
            assert bool((b_res[seen] > 0).all()), f"{name}: zero residual"
            assert bool((a_res[off] == 0).all() and (a_inl[off] == 0).all()), \
                f"{name}: an inactive factor is not zero"
            rel = float(((a_res - b_res).abs()
                         / b_res.abs().clamp(min=1e-12))[seen].max())
            assert rel < ERR_RES_TOL, f"{name}: residual rel err {rel}"
            worst[name]["res"] = max(worst[name]["res"], rel)
        d = float((wk - wp_).abs().max())
        assert d < WARP_ATOL, f"se3_warp_batch: warped differs by {d}"
        assert bool((wk[off] == 0).all()), "inactive render is not zero"
        worst["se3_warp_batch"]["abs"] = max(worst["se3_warp_batch"]["abs"], d)
        worst["sfm_error_batch"]["abs"] = max(
            worst["sfm_error_batch"]["abs"], float((rk - rp).abs().max()))
        n_checks += 1
        return ik

    crops = {hw: {k: levels[1][k][:, :hw[0], :hw[1]].contiguous()
                  for k in ("img", "dpt")} for hw in (ODD_HW, ODD_HW_UNALIGNED)}
    sizes = ([(lv, cams[l]) for l, lv in enumerate(levels)]
             + [(crop, cams[1]) for crop in crops.values()])
    n_plans = 0
    for planes, cam in sizes:
        H_, W_ = planes["img"].shape[1:]
        ps = error_plan_ps(H_, W_)
        n_plans += len(ps)
        for P in sorted(set(ps) | {1, 2, 64}):
            check(*case(P, planes, cam))

    # the timed shapes: the map dump (one call per level over the pool) and
    # one warp render
    for l, lv in enumerate(levels):
        hw = "x".join(map(str, lv["img"].shape[1:]))
        args, active = case(64, lv, cams[l])
        bms, by = bound_of(args, active, False)
        timed["sfm_error_batch"].append(dict(
            ms=cuda_ms(lambda: se.sfm_error_batch(*args, active=active),
                       iters=100),
            plain_ms=cuda_ms(lambda: se.sfm_error_batch_plain(
                *args, active=active), iters=5),
            bound_ms=bms, bound_by=by,
            shape=f"dump P=64 ({int(active.sum())} active) {hw}"))
        args, active = case(1, lv, cams[l])
        bms, by = bound_of(args, active, True)
        timed["se3_warp_batch"].append(dict(
            ms=cuda_ms(lambda: se.se3_warp_batch(*args, active=active),
                       iters=100),
            plain_ms=cuda_ms(lambda: se.se3_warp_batch_plain(
                *args, active=active)),
            bound_ms=bms, bound_by=by, shape=f"P=1 {hw}"))

    # the keyframe gate's shape, level 0
    lv = levels[0]
    gate = gate_case(dev, lv, cams[0], q, t)
    ones2 = torch.ones(2, dtype=torch.int32, device=dev)
    assert bool((check(gate, ones2) > 0).all()), "gate: a hypothesis saw nothing"
    bms, by = bound_of(gate, ones2, False)
    timed["sfm_error_batch"].insert(0, dict(
        ms=cuda_ms(lambda: se.sfm_error_batch(*gate), iters=100),
        plain_ms=cuda_ms(lambda: se.sfm_error_batch_plain(*gate)),
        bound_ms=bms, bound_by=by,
        shape="gate P=2 " + "x".join(map(str, lv["img"].shape[1:]))))

    # every factor inactive: the outputs are torch.empty, so the kernels
    # must write the zeros; the memory they get held NaN just before
    for planes, cam in ((levels[0], cams[0]), (crops[ODD_HW_UNALIGNED], cams[1])):
        args, _ = case(64, planes, cam)
        off = torch.zeros(64, dtype=torch.int32, device=dev)
        torch.full((64,) + tuple(planes["img"].shape[1:]), float("nan"),
                   device=dev)
        torch.full((64, 2), float("nan"), device=dev)
        r, i = se.sfm_error_batch(*args, active=off)
        w, rw, iw = se.se3_warp_batch(*args, active=off)
        torch.cuda.synchronize()
        assert all(bool((x == 0).all()) for x in (r, i, w, rw, iw)), \
            "all factors inactive: an output is not exactly zero"

    # repeated launches: the same bits, also after a launch at another P and
    # size (a ticket that was not reset would not give them)
    main = (gate, ones2)
    other = case(64, crops[ODD_HW_UNALIGNED], cams[1])
    for fn in (se.sfm_error_batch, se.se3_warp_batch):
        first = fn(*main[0], active=main[1])
        for _ in range(2):
            again = fn(*main[0], active=main[1])
            assert all(torch.equal(a, b) for a, b in zip(again, first)), \
                f"{fn.__name__}: two launches on the same inputs differ"
        # no ``active`` (the main path's callers): every factor active
        assert all(torch.equal(a, b) for a, b in zip(fn(*main[0]), first)), \
            f"{fn.__name__}: active=None differs from all-ones"
        odd = fn(*other[0], active=other[1])
        again = fn(*main[0], active=main[1])
        assert all(torch.equal(a, b) for a, b in zip(again, first)), \
            f"{fn.__name__}: differs after a launch at another P and size"
        assert all(torch.equal(a, b) for a, b in zip(
            fn(*other[0], active=other[1]), odd)), fn.__name__
    torch.cuda.synchronize()

    out = {}
    for name, rows in timed.items():
        w = worst[name]
        log(f"{name}: {n_checks} checks ({n_plans} distinct launch plans of "
            f"P = 1..128 at {', '.join('x'.join(map(str, p['img'].shape[1:])) for p, _ in sizes)}"
            f"), inlier counts equal, inactive outputs zero, max rel err "
            f"residual {w['res']:.3e} (tol {ERR_RES_TOL})"
            + (f", max abs err render {w['abs']:.3e} (tol {WARP_ATOL})"
               if name == "se3_warp_batch" else "")
            + "; all inactive exactly 0; repeated launches bit-identical")
        for r in rows:
            log(f"{name} at {r['shape']}: kernel {r['ms']:.5f} ms (an empty "
                f"launch {empty_ms:.5f} ms), plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        out[name] = dict(rows[0], max_abs_err=w["abs"],
                         max_rel_err={"res": w["res"]}, by_shape=rows,
                         empty_launch_ms=empty_ms)
    return out


def warp_diff(a, b):
    """max |a - b| where both are finite; NaN must sit in the same places,
    an infinity must be the same infinity."""
    import torch
    assert torch.equal(torch.isnan(a), torch.isnan(b)), "NaN in other places"
    fin = torch.isfinite(a) & torch.isfinite(b)
    assert torch.equal(a[~fin & ~torch.isnan(a)], b[~fin & ~torch.isnan(b)])
    return float((a[fin] - b[fin]).abs().max())


def tptz_zero_rows(kp, dpt, cam):
    """Set rows 0 and 1 of the source depths dpt [P, h, w], in place, to
    the depth at which R[2]·pt + t_z = 0 under the warp params kp: tptz is
    0 to rounding there, so the coordinates are huge or not finite."""
    import torch
    dev = dpt.device
    w = dpt.shape[2]
    ys, xs = torch.meshgrid(
        torch.arange(2, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    u = (xs - cam.u0) / cam.fx
    v = (ys - cam.v0) / cam.fy
    c = lambda k: kp[:, k, None, None]
    dpt[:, :2] = -c(11) / (c(6) * u + c(7) * v + c(8))


def bilinear_case(dev, K, planes, cam, q, t, seed, with_warp=False):
    """One factor's sampling stage as ``sfm_step`` holds it: the target
    image img1 [h, w], its Sobel planes interleaved as grad1 [h, w, 2], and
    the warped coordinates x1, y1 [h, w] of a perturbed pose, rows 0 and 1
    at tptz ~ 0. ``with_warp``: also dense_warp_batch's samples of the
    three planes [3, h, w] for the same factor (its kernel on a card)."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
    src, dst, _ = factor_set(K, 1, dev, seed=seed)
    sl, dl = src.long(), dst.long()
    pose = perturb(se3m.relative_pose(SE3(q[dl], t[dl]), SE3(q[sl], t[sl])),
                   seed=seed + 1)
    kp = dw.make_warp_params(pose, cam, 2, 0.0)
    dpt = planes["dpt"][sl].clone()
    tptz_zero_rows(kp, dpt, cam)
    img1, gx, gy = (planes[k][dl] for k in ("img", "gx", "gy"))
    op = dw.dense_warp_batch_plain(kp, dpt, img1, gx, gy)
    x1 = (cam.fx * op[3][0] / op[5][0] + cam.u0).contiguous()
    y1 = (cam.fy * op[4][0] / op[5][0] + cam.v0).contiguous()
    grad1 = torch.stack([gx[0], gy[0]], dim=-1).contiguous()
    case = (img1[0].contiguous(), grad1, x1, y1)
    if with_warp:
        case += (torch.stack(dw.dense_warp_batch(kp, dpt, img1, gx, gy)[:3])
                 [:, 0],)
    return case


def first_design_kernel(first_design, chans, x1, y1):
    """The first design's kernel (``first_design``, its C launcher) on
    planes chans [C, h, w] stacked beforehand."""
    import torch
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg
    out = torch.empty_like(chans)
    C, h, w = chans.shape
    code = first_design(sg._ptr(chans), sg._ptr(x1), sg._ptr(y1),
                        sg._ptr(out), C, h, w,
                        torch.cuda.current_stream().cuda_stream)
    assert code == 0, code
    return out


def first_design_stage(first_design, img1, grad1, x1, y1):
    """The sampling stage of ``sfm_step`` as the first design ran it: the
    caller stacks img1 and the two gradient channels, then the first kernel
    (``first_design``, its C launcher) samples the stack."""
    import torch
    return first_design_kernel(
        first_design, torch.stack([img1, grad1[..., 0], grad1[..., 1]]), x1,
        y1)


def bilinear_checks(dev, K, cams, levels, q, t, empty_ms, first_design):
    """bilinear_warp_planes against its twin at every distinct launch plan
    (the three pyramid sizes and ODD_HW_UNALIGNED), C in BILINEAR_CS,
    through both entries (stacked planes; planes read in place at strides
    1, 2 and 6), at coordinates off every side and huge or not finite in
    the tptz ~ 0 rows: bit-identical, NaN in the same places, repeated
    launches the same bits. Then the times: the kernel at C = 3 at the
    three sizes beside its twin and F.grid_sample, and, given
    ``first_design`` (the first kernel's C launcher), the sampling stage of
    ``sfm_step`` at 192x256 in turns with the first design's call pattern.
    Returns (max abs err, timed rows, checks, the in-context row or None)."""
    import torch
    import torch.nn.functional as F
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw

    def same_bits(a, b, what):
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), f"{what}: NaN in other places"
        assert torch.equal(a[~nan], b[~nan]), f"{what}: not bit-identical"

    crop = {k: levels[1][k][:, :ODD_HW_UNALIGNED[0], :ODD_HW_UNALIGNED[1]]
            .contiguous() for k in ("img", "dpt", "gx", "gy")}
    sizes = [(lv, cams[l]) for l, lv in enumerate(levels)] + [(crop, cams[1])]
    g = torch.Generator(device="cpu").manual_seed(17)
    worst, n, rows, cases = 0.0, 0, [], []
    for i, (lv, cam) in enumerate(sizes):
        img1, grad1, x1, y1, warped = bilinear_case(dev, K, lv, cam, q, t,
                                                    60 + i, with_warp=True)
        h, w = img1.shape
        edge = x1[:2]
        assert not bool(torch.isfinite(edge).all()) or \
            float(edge.abs().max()) > 1e6, "tptz ~ 0 was not reached"
        extra = torch.rand((h, w, 6), generator=g).to(dev)
        pool = ([img1, grad1[..., 0], grad1[..., 1]]
                + [extra[..., k] for k in range(6)])
        cases.append((img1, grad1, x1, y1))
        for C in BILINEAR_CS:
            planes = pool[:C]
            chans = torch.stack(planes)
            bp = dw.bilinear_warp_planes_plain(chans, x1, y1)
            bk = dw.bilinear_warp_planes(chans, x1, y1)
            bl = dw.bilinear_warp_plane_list(planes, x1, y1)
            torch.cuda.synchronize()
            what = f"bilinear_warp_planes C={C} {h}x{w}"
            same_bits(bk, bp, what)
            same_bits(bl, bp, what + " (planes in place)")
            worst = max(worst, warp_diff(bk, bp), warp_diff(bl, bp))
            for _ in range(2):
                same_bits(dw.bilinear_warp_plane_list(planes, x1, y1), bl,
                          what + ": a repeated launch")
            n += 2
            if C == 3:
                # the same samples as dense_warp_batch at the same warp
                assert warp_diff(bl, warped) <= DENSE_WARP_ATOL, \
                    f"{what}: differs from dense_warp_batch's samples"

    for img1, grad1, x1, y1 in cases[:3]:
        h, w = img1.shape
        N = h * w
        chans = torch.stack([img1, grad1[..., 0], grad1[..., 1]])
        # the nearest PyTorch call; not the same function at the last row
        # and column, where it blends and the kernel does not
        grid = torch.stack([2 * x1 / (w - 1) - 1, 2 * y1 / (h - 1) - 1],
                           dim=-1)[None].nan_to_num(0.0, 2.0, -2.0)
        lib = lambda: F.grid_sample(chans[None], grid, mode="bilinear",
                                    padding_mode="border", align_corners=True)
        inside = ((x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1))
        bk = dw.bilinear_warp_planes(chans, x1, y1)
        lib_d = float((lib()[0] - bk)[:, inside].abs().max())
        C = chans.shape[0]
        bms, by = bound((2 * C + 2) * N * 4, 30 * N * C)
        rows.append(dict(
            ms_is="back-to-back programmatic dependent launches: each "
            "overlaps its predecessor, so below an empty launch; designs are "
            "compared by in_context",
            ms=cuda_ms(lambda: dw.bilinear_warp_planes(chans, x1, y1),
                       iters=100),
            plain_ms=cuda_ms(lambda: dw.bilinear_warp_planes_plain(
                chans, x1, y1)),
            bound_ms=bms, bound_by=by, library_ms=cuda_ms(lib, iters=100),
            shape=f"C={C} {h}x{w}", grid_sample_max_abs_diff_inside=lib_d))

    ctx = None
    if first_design is not None:
        # the sampling stage of sfm_step after the two PyTorch ops that
        # write its coordinates (pix1x = ... + u0, pix1y = ... + v0): a
        # dependent launch overlaps their tail, so the stage is timed there
        img1, grad1, x1, y1 = cases[0]
        h, w = img1.shape
        u0, v0 = cams[0].u0, cams[0].v0
        xr, yr = x1 - u0, y1 - v0
        bx, by = torch.empty_like(x1), torch.empty_like(y1)
        adds = lambda: (torch.add(xr, u0, out=bx), torch.add(yr, v0, out=by))
        first = lambda: (adds(), first_design_stage(first_design, img1, grad1,
                                                    bx, by))[1]
        new = lambda: (adds(), ds._sample_img_grad_xy(
            img1, grad1, bx.reshape(-1), by.reshape(-1), "sampled"))[1]
        a, b = first(), torch.stack(new())
        torch.cuda.synchronize()
        same_bits(b.reshape(a.shape), a, "sampling stage, first vs new design")
        us = lambda f: 1e3 * cuda_ms(f, iters=100)
        t_first = [us(first)]
        t_new = [us(new), us(new)]
        t_first.append(us(first))
        t_adds = us(adds)
        ctx = dict(shape=f"two coordinate adds + the sampling stage of "
                   f"sfm_step, C=3 {h}x{w}", first_design_us=t_first,
                   new_us=t_new, adds_alone_us=t_adds,
                   first_stage_less_adds_us=[x - t_adds for x in t_first],
                   new_stage_less_adds_us=[x - t_adds for x in t_new],
                   empty_launch_us=1e3 * empty_ms,
                   bound_us=1e3 * bound(8 * h * w * 4, 90 * h * w)[0],
                   order="first, new, new, first, adds")
        log(f"bilinear_warp_planes in context ({ctx['shape']}), in turns "
            f"first / new / new / first: {t_first[0]:.2f} / {t_new[0]:.2f} / "
            f"{t_new[1]:.2f} / {t_first[1]:.2f} us, the two adds alone "
            f"{t_adds:.2f} us (first design: torch.stack + its kernel; new: "
            f"one dependent launch, planes in place); an empty launch "
            f"{1e3 * empty_ms:.2f} us, the stage's bound "
            f"{ctx['bound_us']:.3f} us")
    return worst, rows, n, ctx


def phase_warp_kernels(dev, K, cams, levels, q, t, empty_ms,
                       first_design=None):
    """dense_warp_batch (P = 16, 64 and one chunk of ``sfm_step_batch``)
    against its twin at the three pyramid sizes, at perturbed poses, then
    bilinear_warp_planes (``bilinear_checks``). The first two rows of every
    source depth are set so that tptz is 0 to rounding there: the
    coordinates are huge or not finite, and the kernel must still read
    inside its planes and agree with the twin."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg
    diff = warp_diff

    worst = dict.fromkeys(dw.LAUNCHES, 0.0)
    timed = {n: [] for n in dw.LAUNCHES}
    n_checks = 0
    chunk = ds._JT_CHUNK_BYTES // ((12 + 32) * H * W * 4)
    for P in (16, 64, chunk):
        src, dst, _ = factor_set(K, P, dev, seed=40 + P)
        sl, dl = src.long(), dst.long()
        pose_10 = perturb(se3m.relative_pose(SE3(q[dl], t[dl]),
                                             SE3(q[sl], t[sl])), seed=50 + P)
        for l, lv in enumerate(levels):
            h, w = lv["img"].shape[1:]
            N = h * w
            kp = dw.make_warp_params(pose_10, cams[l], 2, 0.0)
            dpt = lv["dpt"][sl].clone()
            tptz_zero_rows(kp, dpt, cams[l])
            args = (kp, dpt, lv["img"][dl], lv["gx"][dl], lv["gy"][dl])
            ok = dw.dense_warp_batch(*args)
            op = dw.dense_warp_batch_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(ok[6], op[6]), "dense_warp_batch: valid differs"
            clean = ok[6][:, 2:]
            assert float(clean.mean()) > 0.5, "most pixels are invalid"
            near0 = ok[5][:, :2].abs() < 1e-5
            assert float(near0.float().mean()) > 0.9, "tptz ~ 0 was not reached"
            assert float(ok[6][:, :2][near0].mean()) < 0.01
            for k in range(3):
                assert torch.isfinite(ok[k][ok[6] > 0.5]).all()
            d = max(diff(a, b) for a, b in zip(ok[:6], op[:6]))
            assert d <= DENSE_WARP_ATOL, f"dense_warp_batch differs by {d}"
            worst["dense_warp_batch"] = max(worst["dense_warp_batch"], d)
            n_checks += 1
            bms, by = bound((11 * N + sg.PARAM_DIM) * P * 4, 60 * N * P)
            timed["dense_warp_batch"].append(dict(
                ms=cuda_ms(lambda: dw.dense_warp_batch(*args)),
                plain_ms=cuda_ms(lambda: dw.dense_warp_batch_plain(*args),
                                 iters=5),
                bound_ms=bms, bound_by=by, library_ms=None,
                shape=f"P={P} {h}x{w}"))

    worst["bilinear_warp_planes"], timed["bilinear_warp_planes"], n_bil, ctx = \
        bilinear_checks(dev, K, cams, levels, q, t, empty_ms, first_design)

    out = {}
    for name, rows in timed.items():
        if name == "dense_warp_batch":
            log(f"{name}: {n_checks} checks, valid equal, NaN in the same "
                f"places, max abs err {worst[name]:.3e} (tol {DENSE_WARP_ATOL})")
        else:
            log(f"{name}: {n_bil} checks (C = {BILINEAR_CS} at the three "
                f"pyramid sizes and {ODD_HW_UNALIGNED[0]}x"
                f"{ODD_HW_UNALIGNED[1]}, stacked and in place), bit-identical "
                f"to the twin (max abs err {worst[name]:.1e}), NaN in the same "
                f"places, repeated launches the same bits")
        for r in rows:
            log(f"{name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})"
                + (f", F.grid_sample {r['library_ms']:.4f} ms (differs by "
                   f"{r['grid_sample_max_abs_diff_inside']:.2e} inside the image)"
                   if r["library_ms"] is not None else "")
                + (f"; kernel time: {r['ms_is']}" if "ms_is" in r else ""))
        out[name] = dict(rows[0], max_abs_err=worst[name],
                         max_rel_err=None, by_shape=rows)
    if ctx is not None:
        out["bilinear_warp_planes"]["in_context"] = ctx
    return out


# ----------------------------------------------------------------------------
# phase 2c: the weighted Jacobian stack
# ----------------------------------------------------------------------------

def _ulps(a, b):
    """(entries that differ in their bits, the largest distance in units
    in the last place between two finite fp32 tensors of one shape); NaN
    must lie in the same places."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    assert torch.equal(na, nb), "NaN in other places"
    ia = a.masked_fill(na, 0.0).view(torch.int32).long()
    ib = b.masked_fill(nb, 0.0).view(torch.int32).long()
    # the fp32 bit patterns on one monotone integer line
    key = lambda i: torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (key(ia) - key(ib)).abs()
    return int((ia != ib).sum()), int(d.max()) if d.numel() else 0


def _stack_errs(got, want):
    """(max |got - want|, that over max |want|) over the pairs of tensors
    (Jw, rw), NaN places excluded (_ulps holds them to the same places)."""
    import torch
    err = ref = 0.0
    for a, b in zip(got, want):
        keep = ~torch.isnan(b)
        err = max(err, float((a[keep] - b[keep]).abs().max()))
        ref = max(ref, float(b[keep].abs().max()))
    return err, err / ref


def phase_jacobian_stack(dev, K, cam, lv, q, t, codes):
    """2c: jacobian_stack at one chunk of the large map against its twin
    (the eager chain it replaced, which the CPU tests hold to the
    pre-kernel code), Huber and Tukey: Jw and rw bit for bit, pose rows
    included, and JtJ after the bmm too; then with rows at tptz = 0
    (tptz_zero_rows), where the rows are not finite and the weight is 0:
    NaN in the same places. Timed beside its bound."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.geometry.warping import depth_to_prox
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
    from deepfactors_tpu_torch.ops.kernels import jacobian_stack as js

    CS, avg = lv["jac"].shape[1], 2.0
    N = H * W
    P = ds._JT_CHUNK_BYTES // ((12 + CS) * N * 4)
    src, dst, _ = factor_set(K, P, dev, seed=JSTACK_SEED)
    sl, dl = src.long(), dst.long()
    poses0 = perturb(SE3(q[sl], t[sl]), seed=JSTACK_SEED + 1)
    pose_10, j_pose1, j_pose0 = se3m.relative_pose_jacobians(
        SE3(q[dl], t[dl]), poses0)
    kp = dw.make_warp_params(pose_10, cam, 2, 0.0)
    jac0 = lv["jac"][sl].permute(0, 2, 3, 1).contiguous()
    # depth decoded from a code as dist_ba does
    prx = depth_to_prox(lv["dpt"][sl], avg) + torch.einsum(
        "phwc,pc->phw", jac0, codes[sl])
    dpt = (avg / prx - avg).contiguous()
    img0 = lv["img"][sl].contiguous()
    grid = ds._pixel_grid(H, W, dev).reshape(-1, 2)
    u = (grid[:, 0] - cam.u0) / cam.fx
    v = (grid[:, 1] - cam.v0) / cam.fy
    warp = dw.dense_warp_batch(kp, dpt, lv["img"][dl], lv["gx"][dl],
                               lv["gy"][dl])
    js.reset_launch_counts()
    rows = []
    for loss in ("huber", "tukey"):
        args = (kp, warp, dpt, img0, jac0, j_pose0, j_pose1, u, v,
                JSTACK_DELTA, avg, loss)
        before = js.LAUNCHES["jacobian_stack"]
        Jk, rk = js.jacobian_stack(*args)
        Jp, rp = js.jacobian_stack_plain(*args)
        torch.cuda.synchronize()
        assert js.LAUNCHES["jacobian_stack"] == before + 1, js.LAUNCHES
        assert Jk.shape == (P, 12 + CS, N) and Jk.is_contiguous()
        assert torch.isfinite(Jk).all() and torch.isfinite(rk).all()
        assert float((rk != 0).float().mean()) > 0.5, "most rows weigh 0"
        bits = lambda x: x.view(torch.int32)
        assert torch.equal(bits(Jk[:, 12:]), bits(Jp[:, 12:])), \
            f"{loss}: code rows differ from the twin's: {_ulps(Jk[:, 12:], Jp[:, 12:])}"
        assert torch.equal(bits(rk), bits(rp)), f"{loss}: rw differs"
        pose_n, pose_ulp = _ulps(Jk[:, :12], Jp[:, :12])
        assert pose_n == 0, f"{loss}: pose rows differ, at most {pose_ulp} ulp"
        Gk = Jk @ Jk.transpose(-1, -2)
        Gp = Jp @ Jp.transpose(-1, -2)
        jtj_n, jtj_ulp = _ulps(Gk, Gp)
        assert jtj_n == 0, f"{loss}: JtJ differs, at most {jtj_ulp} ulp"
        abs_err, rel_err = _stack_errs((Jk, rk), (Jp, rp))
        del Jp, Gk, Gp
        nbytes = 4 * (22 + 2 * CS) * N * P
        bms, by = bound(nbytes, (54 + 144 + 2 * CS + 7 + 13) * N * P)
        row = dict(loss=loss, shape=f"P={P} {H}x{W} CS {CS}",
                   pose_rows_differing=pose_n, pose_rows_max_ulp=pose_ulp,
                   jtj_differing=jtj_n, jtj_max_ulp=jtj_ulp,
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   ms=cuda_ms(lambda: js.jacobian_stack(*args)),
                   plain_ms=cuda_ms(lambda: js.jacobian_stack_plain(*args),
                                    iters=5),
                   bound_ms=bms, bound_by=by, library_ms=None)
        rows.append(row)
        log(f"jacobian_stack {loss} at {row['shape']}: Jw (pose rows "
            f"included) and rw bit for bit the twin's, JtJ after the bmm "
            f"too; max |Jw, rw - twin| {abs_err}, relative {rel_err}; "
            f"kernel {row['ms']:.4f} ms, "
            f"bound {bms:.4f} ms ({by}, {nbytes / 1e9:.3f} GB), "
            f"{100 * bms / row['ms']:.1f}% of it; twin "
            f"{row['plain_ms']:.4f} ms")
    # rows at tptz = 0: not finite, weighed 0, NaN where the eager chain has
    dz = dpt.clone()
    tptz_zero_rows(kp, dz, cam)
    wz = dw.dense_warp_batch(kp, dz, lv["img"][dl], lv["gx"][dl],
                             lv["gy"][dl])
    args = (kp, wz, dz, img0, jac0, j_pose0, j_pose1, u, v, JSTACK_DELTA,
            avg, "huber")
    Jk, rk = js.jacobian_stack(*args)
    Jp, rp = js.jacobian_stack_plain(*args)
    torch.cuda.synchronize()
    nan = torch.isnan(Jk)
    assert bool(nan.any()) and torch.equal(nan, torch.isnan(Jp))
    assert torch.equal(Jk[:, 12:].view(torch.int32),
                       Jp[:, 12:].view(torch.int32))
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    nan_n, nan_ulp = _ulps(Jk[:, :12], Jp[:, :12])
    assert nan_n == 0, f"tptz = 0: pose rows differ, at most {nan_ulp} ulp"
    del Jk, Jp
    # a partial last strip, the tile without 16-byte loads (CS 5), and more
    # than 48 KB of shared memory (CS 64), on synthetic planes
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    g = torch.Generator(device="cpu").manual_seed(JSTACK_SEED + 2)
    rnd = lambda *shape: torch.rand(shape, generator=g).to(dev)
    edge = []
    for ce, he, we in ((5, 89, 121), (8, 90, 122), (64, 48, 64)):
        cam_e = PinholeCamera.create(fx=80.0, fy=80.0, u0=we / 2, v0=he / 2,
                                     width=we, height=he)
        kp_e = dw.make_warp_params(se3m.index(pose_10, slice(0, 3)), cam_e,
                                   2, 0.0)
        dpt_e = 1.5 + rnd(3, he, we)
        warp_e = dw.dense_warp_batch(kp_e, dpt_e, rnd(3, he, we),
                                     rnd(3, he, we) - 0.5,
                                     rnd(3, he, we) - 0.5)
        grid_e = ds._pixel_grid(he, we, dev).reshape(-1, 2)
        args = (kp_e, warp_e, dpt_e, rnd(3, he, we),
                0.02 * (rnd(3, he, we, ce) - 0.5), j_pose0[:3].contiguous(),
                j_pose1[:3].contiguous(), (grid_e[:, 0] - cam_e.u0) / cam_e.fx,
                (grid_e[:, 1] - cam_e.v0) / cam_e.fy, JSTACK_DELTA, avg,
                "huber")
        Je, re = js.jacobian_stack(*args)
        Jq, rq = js.jacobian_stack_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(Je).all() and float((re != 0).float().mean()) > 0.3
        assert torch.equal(Je.view(torch.int32), Jq.view(torch.int32)) and \
            torch.equal(re.view(torch.int32), rq.view(torch.int32)), \
            f"CS {ce} at {he}x{we}: {_ulps(Je, Jq)}"
        edge.append(f"CS {ce} at {he}x{we}")
    launches = js.LAUNCHES["jacobian_stack"]
    # a call, then cuda_ms's 3 + 20, for each loss; the call at tptz = 0;
    # one for each edge case
    assert launches == len(rows) * (1 + 3 + 20) + 1 + len(edge), js.LAUNCHES
    log(f"jacobian_stack at tptz = 0: {int(nan.sum())} NaN entries, in the "
        f"twin's places; Jw and rw bit for bit elsewhere. Bit for bit the "
        f"twin's at "
        f"{', '.join(edge)}; {launches} launches in the phase (one a call)")
    return {"jacobian_stack": dict(
        rows[0], max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_err=max(r["max_rel_err"] for r in rows), by_shape=rows)}


# ----------------------------------------------------------------------------
# phase 2b: the reprojection operators, card against CPU
# ----------------------------------------------------------------------------

def _descriptor_bits(a, b):
    """Bits that differ between two int32 descriptor sets [K, 8], per row."""
    x = np.bitwise_xor(a.cpu().numpy().view(np.uint32),
                       b.cpu().numpy().view(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _block_errs(a, b, CS):
    """Largest |a - b| of each (pose0, pose1, code) block of JtJ [P, D, D]
    and Jtr [P, D], each over that block's largest |b|."""
    cuts = [(0, 6), (6, 12), (12, 12 + CS)]
    a, b = a.double().cpu(), b.double().cpu()
    if b.dim() == 2:
        return max(float((a[:, i:j] - b[:, i:j]).abs().max()
                         / b[:, i:j].abs().max().clamp(min=1e-30))
                   for i, j in cuts)
    return max(float((a[:, i:j, k:l] - b[:, i:j, k:l]).abs().max()
                     / b[:, i:j, k:l].abs().max().clamp(min=1e-30))
               for i, j in cuts for k, l in cuts)


def phase_rep_ops(dev):
    """Phase 2b: detection, matching, RANSAC and the reprojection system on
    the card against the same functions on the CPU, at the main path's
    shapes (192x256, 3 octaves, 128 keypoints, 128 hypotheses, CS 32)."""
    import torch
    from deepfactors_tpu_torch.features import detector as det
    from deepfactors_tpu_torch.features import matching as mt
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.loop import vocabulary as vb
    from deepfactors_tpu_torch.ops import image as ip
    from deepfactors_tpu_torch.ops import sparse_factors as sf

    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)
    pair = [poses[i] for i in REP_FRAMES]
    frames = synth.render_sequence(synth.random_room(7, n_boxes=3), cam, pair,
                                   H, W, device="cpu")
    dcfg = det.DetectorConfig(max_keypoints=128)
    out = {}

    def timed(name, fn):
        """Device ms per call behind a ~1 s spin (these plain-PyTorch ops
        make hundreds of launches a call, so the host needs ~10-20 ms to
        enqueue one), and host ms per call, each call ending in a
        synchronise."""
        out[name] = cuda_ms(fn, iters=10, spin_cycles=2_000_000_000)
        t = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
        out[name + "_host"] = float(np.median(t))

    # detection
    pyr = {d: [ip.build_pyramid(torch.as_tensor(np.asarray(f), device=d), 3)
               for f in frames] for d in ("cpu", dev)}
    feats = {d: [det.detect_pyramid(p, dcfg) for p in pyr[d]]
             for d in ("cpu", dev)}
    bits = []
    for fc, fg in zip(feats["cpu"], feats[dev]):
        assert torch.equal(fc.valid, fg.valid.cpu()), "keypoint validity"
        v = fc.valid
        assert torch.equal(fc.xy[v], fg.xy.cpu()[v]), "keypoint xy"
        bits.append(_descriptor_bits(fc.descriptor[v], fg.descriptor[v]))
    nbits = np.concatenate(bits)
    assert nbits.max(initial=0) <= 1 and nbits.sum() <= 2, nbits
    n_kp = [int(f.valid.sum()) for f in feats["cpu"]]
    timed("detect_ms", lambda: det.detect_pyramid(pyr[dev][0], dcfg))

    # BoW with the shipped vocabulary, on the CPU's descriptors on both
    # sides: the words of every descriptor, and the similarities of the
    # frames' vectors against a loop database of K + A = 96 rows
    voc = {d: vb.default_vocabulary(device=d) for d in ("cpu", dev)}
    for f in feats["cpu"]:
        assert torch.equal(vb.assign_words(voc["cpu"], f.descriptor),
                           vb.assign_words(voc[dev],
                                           f.descriptor.to(dev)).cpu()), \
            "BoW words"
    bows = {d: torch.stack([vb.bow_vector(voc[d], f.descriptor.to(d),
                                          f.valid.to(d))
                            for f in feats["cpu"]]) for d in ("cpu", dev)}
    g = torch.Generator().manual_seed(5)
    db = torch.rand((96, 256), generator=g)
    db = db / db.sum(dim=1, keepdim=True)
    db[:2] = bows["cpu"]
    db_ok = torch.rand(96, generator=g) > 0.3
    db_ok[:2] = True
    bow_err = 0.0
    for i in range(2):
        sc = vb.similarity(bows["cpu"][i], db, db_ok)
        sg_ = vb.similarity(bows[dev][i], db.to(dev), db_ok.to(dev)).cpu()
        assert torch.equal(torch.isinf(sc), torch.isinf(sg_))
        bow_err = max(bow_err, float((sc - sg_)[db_ok].abs().max()))
    assert bow_err <= BOW_SIM_TOL, bow_err
    fdev = [f.descriptor.to(dev) for f in feats["cpu"]]
    vdev = [f.valid.to(dev) for f in feats["cpu"]]
    timed("bow_ms", lambda: vb.bow_vector(voc[dev], fdev[0], vdev[0]))
    db_dev, ok_dev = db.to(dev), db_ok.to(dev)
    timed("similarity_ms", lambda: vb.similarity(bows[dev][0], db_dev,
                                                 ok_dev))

    # matching both ways, on the CPU's descriptors on both sides
    f0, f1 = feats["cpu"]
    D0 = torch.stack([f0.descriptor, f1.descriptor])
    D1 = torch.stack([f1.descriptor, f0.descriptor])
    V0 = torch.stack([f0.valid, f1.valid])
    V1 = torch.stack([f1.valid, f0.valid])
    mc = mt.match(D0, V0, D1, V1, max_dist=30)
    on = lambda *xs: [x.to(dev) for x in xs]
    mg = mt.match(*on(D0, V0, D1, V1), max_dist=30)
    for n in mt.Matches._fields:
        assert torch.equal(getattr(mc, n), getattr(mg, n).cpu()), f"match {n}"
    mdev = on(D0, V0, D1, V1)
    timed("match_ms", lambda: mt.match(*mdev, max_dist=30))

    # RANSAC with the same draws on both sides
    XY0 = torch.stack([f0.xy, f1.xy])
    XY1 = torch.gather(torch.stack([f1.xy, f0.xy]), 1,
                       mc.idx1.long()[..., None].expand(-1, -1, 2))
    idx = mt.draw_hypotheses(mc.valid, REP_RANSAC_ITERS,
                             torch.Generator().manual_seed(0))
    thr = 1e-4
    ic = mt.prune_matches_eight_point(XY0, XY1, mc.valid, cam, idx=idx,
                                      threshold=thr)
    ig = mt.prune_matches_eight_point(*on(XY0, XY1, mc.valid), cam,
                                      idx=idx.to(dev), threshold=thr).cpu()
    b0, b1 = mt.bearing_vectors(cam, XY0), mt.bearing_vectors(cam, XY1)
    gat = lambda b: torch.gather(
        b[:, None].expand(-1, REP_RANSAC_ITERS, -1, -1), 2,
        idx[..., None].expand(-1, -1, -1, 3))
    errs = mt._epipolar_error(mt._essential_from_8(gat(b0), gat(b1)), b0, b1)
    best = torch.argmax(torch.sum((errs < thr) & mc.valid[:, None], -1), -1)
    e_best = errs[torch.arange(2), best]
    near = (e_best - thr).abs() <= 1e-3 * thr
    assert torch.equal(ic[~near], ig[~near]), "RANSAC inlier masks"
    gdraw = torch.Generator(device=dev).manual_seed(42)
    rdev = on(XY0, XY1, mc.valid)
    timed("ransac_ms", lambda: mt.prune_matches_eight_point(
        *rdev, cam, idx=mt.draw_hypotheses(rdev[2], REP_RANSAC_ITERS, gdraw),
        threshold=thr))
    A = torch.randn((2 * REP_RANSAC_ITERS, 8, 9), device=dev)
    A9 = torch.cat([A, torch.zeros_like(A[:, :1])], dim=1)
    timed("svd_8x9_ms", lambda: torch.linalg.svd(A, full_matrices=True))
    timed("svd_9x9_ms", lambda: torch.linalg.svd(A9, full_matrices=True))

    # the reprojection system of both directions, images in a 2-slot pool
    rng = np.random.RandomState(3)
    CS = 32
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    prx = np.stack([0.45 + 0.05 * np.sin(xs / (17 + k)) * np.cos(ys / 13)
                    for k in range(2)]).astype(np.float32)
    jac = (0.01 * rng.randn(2, CS, H, W)).astype(np.float32)
    code = (0.3 * rng.randn(2, CS)).astype(np.float32)
    pq = np.stack([p.q for p in pair]).astype(np.float32)
    pt = np.stack([p.t for p in pair]).astype(np.float32)
    inl = mc.valid & ic

    def rep_args(d, P=2):
        """The inputs on device ``d``, the pair's two directions repeated
        to P factors over the same 2-slot image pool."""
        t = lambda a: torch.as_tensor(np.asarray(a), device=d)
        rp = lambda x: x.to(d).repeat((P // 2,) + (1,) * (x.dim() - 1))
        return (SE3(rp(t(pq)), rp(t(pt))),
                SE3(rp(t(pq[::-1].copy())), rp(t(pt[::-1].copy()))),
                rp(t(code)), cam, rp(XY0), rp(XY1), rp(inl), t(prx), t(jac),
                rp(torch.arange(2)))

    def rep_sys(args):
        *a, src = args
        return sf.reprojection_system(*a, huber_delta=0.1, sigma=1.0,
                                      avg_dpt=2.0, src=src)

    rc, rg = rep_sys(rep_args("cpu")), rep_sys(rep_args(dev))
    err_jtj = _block_errs(rg.JtJ, rc.JtJ, CS)
    err_jtr = _block_errs(rg.Jtr, rc.Jtr, CS)
    assert err_jtj <= REP_SYS_TOL and err_jtr <= REP_SYS_TOL, (err_jtj,
                                                               err_jtr)
    assert torch.equal(rc.inliers, rg.inliers.cpu()), "rep inliers"
    assert float(rc.inliers.min()) > 0
    a2, a32 = rep_args(dev), rep_args(dev, 32)
    timed("rep_system_ms_p2", lambda: rep_sys(a2))
    timed("rep_system_ms_p32", lambda: rep_sys(a32))
    log(f"rep ops: frames {REP_FRAMES} of room 7, keypoints {n_kp}, matches "
        f"{mc.valid.sum(-1).tolist()}, RANSAC inliers "
        f"{inl.sum(-1).tolist()} (card == CPU, {int(near.sum())} matches on "
        f"the threshold), descriptor bits differing card/CPU "
        f"{int(nbits.sum())}; reprojection_system JtJ {err_jtj:.2e} Jtr "
        f"{err_jtr:.2e} of each block's max (tol {REP_SYS_TOL}); BoW words "
        f"card == CPU, similarities within {bow_err:.2e} (tol {BOW_SIM_TOL})")
    log("rep ops on the card, device ms / host ms a call: detect_pyramid "
        "{detect_ms:.3f} / {detect_ms_host:.2f}, match (2 directions) "
        "{match_ms:.3f} / {match_ms_host:.2f}, draw + RANSAC (2 directions, "
        "128 hypotheses) {ransac_ms:.3f} / {ransac_ms_host:.2f}, batched SVD "
        "of 256 8x9 {svd_8x9_ms:.3f} / {svd_8x9_ms_host:.2f} (9x9 "
        "zero-padded {svd_9x9_ms:.3f} / {svd_9x9_ms_host:.2f}), "
        "reprojection_system P=2 {rep_system_ms_p2:.3f} / "
        "{rep_system_ms_p2_host:.2f}, P=32 {rep_system_ms_p32:.3f} / "
        "{rep_system_ms_p32_host:.2f}, bow_vector (128 descriptors, 256 "
        "words) {bow_ms:.3f} / {bow_ms_host:.2f}, similarity (96 rows) "
        "{similarity_ms:.3f} / {similarity_ms_host:.2f}".format(**out)
        + f"; {smi_line()}")
    return out


# ----------------------------------------------------------------------------
# phase 3: decoder
# ----------------------------------------------------------------------------

def phase_decoder(dev):
    import torch
    from deepfactors_tpu_torch.models.decoder import load_decoder

    dec = load_decoder(os.path.join("data", "nets", "room256_32v4"), device=dev)
    rng = np.random.RandomState(0)
    img = torch.tensor(rng.rand(H, W).astype(np.float32), device=dev)
    ms = cuda_ms(lambda: dec.raw_outputs_T(img), iters=10)
    out = dec.raw_outputs_T(img)
    dec_cpu = load_decoder(os.path.join("data", "nets", "room256_32v4"),
                           device="cpu")
    ref = dec_cpu.raw_outputs_T(img.cpu())
    for key in ("prx0", "jac", "stdev"):
        for a, b in zip(out[key], ref[key]):
            assert torch.isfinite(a).all()
            err = float((a.cpu() - b).abs().max() / b.abs().max())
            assert err < DECODER_TOL, f"decoder {key}: {err}"
    err = float((out["code_pred"].cpu() - ref["code_pred"]).abs().max()
                / ref["code_pred"].abs().max())
    assert err < DECODER_TOL, f"decoder code_pred: {err}"
    log("decoder room256_32v4: prx0 "
        + str([tuple(p.shape) for p in out["prx0"]]) + ", jac "
        + str([tuple(j.shape) for j in out["jac"]]) + ", code "
        + str(tuple(out["code_pred"].shape)) + f"; forward {ms:.3f} ms; "
        f"card vs CPU within {DECODER_TOL}")
    return dec


# ----------------------------------------------------------------------------
# phases 4 and 5: end to end
# ----------------------------------------------------------------------------

def launch_counts():
    from deepfactors_tpu_torch.ops import kernels
    return kernels.launch_counts()


def reset_launch_counts():
    from deepfactors_tpu_torch.ops import kernels
    kernels.reset_launch_counts()


def sum_counts(counts):
    """Launch counts (``launch_counts()`` dicts, one a rank or a part)
    summed kernel by kernel."""
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def stat(v):
    return (f"n={len(v)} mean {np.mean(v):.1f} median {np.median(v):.1f} "
            f"p90 {np.percentile(v, 90):.1f} max {np.max(v):.1f} ms"
            if v else "n=0")


def run_facade(dev, decoder, tag, scene_seed, n_frames, max_keyframes,
               max_factors, frame_dist_threshold=0.12, use_reprojection=False,
               loop_closure=False, schedule=None,
               tracking_error_threshold=0.3,
               loop_active_window=LOOP_ACTIVE_WINDOW,
               loop_max_dist=LOOP_MAX_DIST, time_parts=True, trace=None,
               ransac_draw=None, system_cfg=None, setup=None,
               native_scheduler=False):
    """The sequential facade over the first ``n_frames`` of the room orbit,
    bootstrap on frames 0 and 2. Sets the launch counts to 0 first. Returns
    the facade, the scene's camera and frames, and the run's readings; with
    reprojection factors on also the per-event match and inlier counts;
    with loop closure on (tools/bench_e2e.py's loop settings and the shipped
    vocabulary) also every dense verification (frame, candidates, kernel
    launches, inlier shares) and every relocalisation. With ``time_parts``
    also the host milliseconds of the parts, each timed between two
    synchronises: evictions, detection, match + RANSAC, rep assembly, each
    dense verification, each relocalisation and each ``detect_pyramid``
    call. Those synchronises fall inside the frame latencies, so a run
    whose frame latencies are reported keeps ``time_parts`` off.
    ``schedule`` is the list of frames fed after the bootstrap, an index of
    the orbit or -1 for a frame of noise (default: 3 .. n_frames - 1).
    ``trace``: a file for port_tools/decision_trace.py's per-frame trace;
    ``ransac_draw``: the mapper's RANSAC draw hook (default: its own).
    ``system_cfg``: a whole ``SystemConfig`` in place of the one built
    from the arguments above (its mapper's height and width must be the
    scene's); ``setup``: a function called with the facade before the
    bootstrap (instrumentation of its own); ``native_scheduler``: the
    mapper's work schedule on the native C++ backend.
    On the CPU (``dev="cpu"``) the kernels' plain twins run and the launch
    counts stay 0."""
    import torch
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.features import detector as det
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.loop.vocabulary import default_vocabulary
    from deepfactors_tpu_torch.mapping.mapper import MapperConfig
    from deepfactors_tpu_torch.system import DeepFactors, SystemConfig
    from deepfactors_tpu_torch.utils import tum_io

    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    scene = synth.random_room(scene_seed, n_boxes=3)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)[:n_frames]
    frames = synth.render_sequence(scene, cam, poses, H, W, device=dev)
    cfg = SystemConfig(
        mapper=MapperConfig(
            max_keyframes=max_keyframes, max_frames=2,
            max_factors=max_factors, code_size=32,
            height=H, width=W, pyramid_levels=3, pho_iters=(4, 8, 15),
            connection_mode="LASTN", max_back_connections=2,
            use_reprojection=use_reprojection,
            use_native_scheduler=native_scheduler),
        dist_threshold=2.0, tracking_dist_threshold=5.0,
        tracking_error_threshold=tracking_error_threshold,
        frame_dist_threshold=frame_dist_threshold, loop_closure=loop_closure,
        loop_active_window=loop_active_window, loop_max_dist=loop_max_dist)
    if system_cfg is not None:
        cfg = system_cfg
        use_reprojection = cfg.mapper.use_reprojection
        loop_closure = cfg.loop_closure
    df = DeepFactors(cfg, cam, decoder=decoder,
                     vocabulary=(default_vocabulary(device=dev)
                                 if loop_closure else None), device=dev)

    # evictions: the victims the callback saw, and the host milliseconds of
    # each eviction and of its device part (each ending in a synchronise)
    evicted, evict_ms, eliminate_ms = [], [], []
    on_evict = df.mapper.evict_callback

    def record(slot, kid):
        evicted.append(kid)
        on_evict(slot, kid)

    df.mapper.evict_callback = record
    if ransac_draw is not None:
        df.mapper.ransac_draw = ransac_draw
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)

    def timed(fn, sink):
        if not time_parts:
            return fn

        def wrapper(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    df.mapper.marginalize_keyframe = timed(df.mapper.marginalize_keyframe,
                                           evict_ms)
    df.mapper._eliminate = timed(df.mapper._eliminate, eliminate_ms)
    # reprojection: host ms of detection (per keyframe built), of match +
    # RANSAC (per keyframe event) and of rep assembly (per GN iteration),
    # each ending in a synchronise; matched and surviving counts per
    # direction, read after the run
    rep_ms = {"detect": [], "match_ransac": [], "rep_assembly": []}
    rep_counts = []     # per event: (matched [2n], inliers [2n]) tensors
    if use_reprojection:
        m = df.mapper
        m._detect = timed(m._detect, rep_ms["detect"])
        m._rep_assemble = timed(m._rep_assemble, rep_ms["rep_assembly"])
        rep_pairs = timed(m._rep_pairs, rep_ms["match_ransac"])
        draw = m.ransac_draw

        def counting_draw(valids, iters):
            rep_counts.append([valids.sum(-1)])
            return draw(valids, iters)

        def counting_pairs(slot_pairs):
            out = rep_pairs(slot_pairs)
            rep_counts[-1].append((out[..., 4] > 0.5).sum(-1))
            return out

        m.ransac_draw = counting_draw
        m._rep_pairs = counting_pairs
    # loop closure: each verification of a candidate set (frame, padded
    # batch, kernel launches; its packed result, read after the run), each
    # relocalisation attempt (frame, accepted, resurrection, launches) and,
    # with time_parts, the host ms of each and of every detect_pyramid call
    verifies, relocs, detect_ms = [], [], []
    frame_no = [0]
    orig_detect = det.detect_pyramid
    if loop_closure:
        ld = df.loop_detector
        verify = ld._verify

        def counting_verify(*a):
            before = launch_counts()["se3_gram_batch"]
            t = time.perf_counter()
            out = verify(*a)
            if time_parts:
                sync()
            verifies.append(dict(
                frame=frame_no[0], C=int(out.shape[0]), packed=out,
                launches=launch_counts()["se3_gram_batch"] - before,
                ms=(time.perf_counter() - t) * 1e3 if time_parts else None))
            return out

        ld._verify = counting_verify
        det.detect_pyramid = timed(orig_detect, detect_ms)
    relocalize = df._relocalize

    def counting_relocalize(img):
        before = launch_counts()["se3_gram_batch"]
        n_kf = df.mapper._next_kid
        if time_parts:
            sync()
        t = time.perf_counter()
        ok = relocalize(img)
        if time_parts:
            sync()
        relocs.append(dict(frame=frame_no[0], ok=ok,
                           resurrected=df.mapper._next_kid > n_kf,
                           launches=launch_counts()["se3_gram_batch"] - before,
                           ms=(time.perf_counter() - t) * 1e3
                           if time_parts else None))
        return ok

    df._relocalize = counting_relocalize
    if setup is not None:
        setup(df)
    # the module-level patch of detect_pyramid is undone however the run ends
    try:
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
        sync()
        boot_s = time.perf_counter() - t0
        close_trace = None
        if trace:
            sys.path.insert(0, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "port_tools"))
            import decision_trace
            close_trace = decision_trace.attach(df, trace)
        df.trajectory = [(0.0, df.pose_wc)]
        # per event kind: host milliseconds of each frame, and the kernel
        # launches the kind made in all
        ms_by = {"tracking-only frames": [], "one-way-frame events": [],
                 "keyframe events": []}
        launches_by = {k: dict.fromkeys(launch_counts(), 0) for k in ms_by}
        launches_by["bootstrap"] = launch_counts()
        n_frames_enq = int(df.mapper.frames.next_id)
        # frames fed -> (rigid ATE so far, keyframes built, evictions)
        ate_at = {}
        noise = np.random.RandomState(0).rand(H, W).astype(np.float32)
        loop_at = []    # (frame, loop link) of every accepted loop
        if schedule is None:
            schedule = list(range(3, n_frames))
        for k, i in enumerate(schedule):
            n_kf = df.mapper._next_kid
            n_links = len(df.loop_links)
            before = launch_counts()
            frame_no[0] = i
            t1 = time.perf_counter()
            # a noise frame carries a timestamp no orbit frame has
            df.process_frame(float(i) if i >= 0 else 1e6 + k,
                             frames[i] if i >= 0 else noise)
            sync()
            dt = (time.perf_counter() - t1) * 1e3
            n_fr = int(df.mapper.frames.next_id)
            kind = ("keyframe events" if df.mapper._next_kid > n_kf else
                    "one-way-frame events" if n_fr > n_frames_enq else
                    "tracking-only frames")
            n_frames_enq = n_fr
            ms_by[kind].append(dt)
            for k_, v in launch_counts().items():
                launches_by[kind][k_] += v - before[k_]
            loop_at += [(i, str(link)) for link in df.loop_links[n_links:]]
            if (i + 1) % 20 == 0 and i == k + 3:
                est = df.trajectory
                ate_at[i + 1] = (round(tum_io.ate_rmse(
                    est, [(ts, poses[int(ts)]) for ts, _ in est]), 4),
                    df.mapper._next_kid, df.n_evictions)
    finally:
        det.detect_pyramid = orig_detect
    total_s = time.perf_counter() - t0
    if close_trace is not None:
        close_trace()
    # the verified candidates: the batch is padded by repeating candidate 0
    for v in verifies:
        pk = v.pop("packed").cpu().numpy()
        n = len(pk)
        while n > 1 and np.array_equal(pk[n - 1], pk[0]):
            n -= 1
        v.update(cands=n, inliers=[round(float(x), 4) for x in pk[:n, 7]],
                 t_norm=[round(float(x), 4) for x in
                         np.linalg.norm(pk[:n, 4:7], axis=-1)])

    est = df.trajectory
    for _, p in est:
        assert np.isfinite(p.q).all() and np.isfinite(p.t).all(), "non-finite pose"
    assert all(ts < len(poses) for ts, _ in est), "a noise frame was tracked"
    gt = [(ts, poses[int(ts)]) for ts, _ in est]
    ate = tum_io.ate_rmse(est, gt)
    tracked = 1.0 - df.n_lost_frames / max(df.n_frames, 1)
    log(f"{tag}: {df.n_frames} frames after bootstrap ({boot_s:.2f} s), total "
        f"{total_s:.2f} s, {1e3 * total_s / n_frames:.1f} ms/frame overall")
    for kind, v in ms_by.items():
        log(f"{tag} {kind}: {stat(v)}")
    if time_parts:
        log(f"{tag} evictions: {stat(evict_ms)}; of which linearise + Schur "
            f"+ PSD projection on the card: {stat(eliminate_ms)}")
    log(f"{tag} keyframes built {df.mapper._next_kid}, live "
        f"{len(df.mapper.kf_slots)}, evicted {df.n_evictions}, one-way frames "
        f"{len(ms_by['one-way-frame events'])}, tracked fraction "
        f"{tracked:.4f}, lost {df.n_lost_frames}, rigid ATE {ate:.4f} m")
    log(f"{tag} (ATE m, keyframes built, evictions) by frames fed: {ate_at}")
    log(f"{tag} kernel launches: {launch_counts()}; by event kind: "
        f"{launches_by}")
    counts = [(a.tolist(), b.tolist()) for a, b in rep_counts]
    if use_reprojection:
        m = df.mapper
        log(f"{tag} reprojection: {len(counts)} matching events, matched / "
            f"surviving RANSAC per direction: {counts}; rep factors live "
            f"{int(m.rep_pool.active.sum())}; GN iterations assembling rep "
            f"factors {m.rep_stats['iterations']} ({m.rep_stats['factor_terms']}"
            f" factor terms)")
    if use_reprojection and time_parts:
        log(f"{tag} keyframe-event parts, host ms each ending in a "
            f"synchronise: detection per keyframe built {stat(rep_ms['detect'])}"
            f"; match + RANSAC per event {stat(rep_ms['match_ransac'])}; rep "
            f"assembly per GN iteration {stat(rep_ms['rep_assembly'])}; "
            f"{smi_line() if dev != 'cpu' else 'cpu'}")
    if loop_closure:
        log(f"{tag} loops: local links {df.n_local_links}, live global loops "
            f"{df.n_live_global_loops}, archived loops {df.n_archived_loops}; "
            f"accepted at (frame, link) {loop_at}; relocalisations "
            f"{df.n_relocalizations} of {len(relocs)} attempts: {relocs}")
        log(f"{tag} dense verifications of global-loop candidates: "
            f"{len(verifies)}; (frame, candidates, padded batch, "
            f"se3_gram_batch launches, inlier shares, translations m): "
            + str([(v["frame"], v["cands"], v["C"], v["launches"],
                    v["inliers"], v["t_norm"]) for v in verifies]))
        if time_parts:
            log(f"{tag} loop-closure parts, host ms each between two "
                f"synchronises: dense verification "
                f"{stat([v['ms'] for v in verifies])}; detect_pyramid (every "
                f"frame and every keyframe built) {stat(detect_ms)}; "
                f"{smi_line() if dev != 'cpu' else 'cpu'}")
    return dict(df=df, cam=cam, frames=frames, ate=ate, tracked=tracked,
                evicted=evicted, ate_at=ate_at, rep_counts=counts,
                rep_ms=rep_ms, ms_by=ms_by, verifies=verifies, relocs=relocs,
                detect_ms=detect_ms, loop_at=loop_at, poses=poses)

def phase_e2e(dev, decoder):
    """Phase 4: 60 frames in a window of 32 keyframes (no eviction), in the
    default configuration: reprojection factors on."""
    r = run_facade(dev, decoder, "e2e", scene_seed=7, n_frames=N_FRAMES,
                   max_keyframes=32, max_factors=128, use_reprojection=True)
    launches = launch_counts()
    df = r["df"]
    m = df.mapper
    assert df.n_lost_frames == 0 and r["tracked"] == 1.0, "frames lost"
    assert df.n_evictions == 0, "a window of 32 evicted"
    path = ("se3_gram_batch", "sfm_gram_batch", "sfm_error_batch")
    assert all(launches[k] > 0 for k in path), f"kernel not launched: {launches}"
    # rep factors were built: one matching event per keyframe event, and
    # at least one rep factor for every keyframe event after the first (the
    # JAX facade's CPU run builds 0, 1, 3, 4, 4, 4, 3, 4, 4 in its nine)
    n_events = m._next_kid - 2
    assert len(r["rep_counts"]) == n_events > 0, (len(r["rep_counts"]),
                                                 n_events)
    built = [sum(n >= 8 for n in inl) for _, inl in r["rep_counts"]]
    assert all(k >= 1 for k in built[1:]), f"rep factors per event {built}"
    assert int(m.rep_pool.active.sum()) == sum(built), built
    # ... and assembled into the GN system
    assert m.rep_stats["iterations"] > 0 and m.rep_stats["factor_terms"] > 0
    assert len(r["rep_ms"]["rep_assembly"]) >= m.rep_stats["iterations"]
    assert r["ate"] < ATE_BOUND_M, f"ATE {r['ate']} >= {ATE_BOUND_M}"
    return launches


def phase_long_run(dev, decoder):
    """Phase 5: the run that outlives its keyframe window, then the map
    dump with per-factor errors and one warp render."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops import dense_sfm as ds

    r = run_facade(dev, decoder, "long run", scene_seed=LONG_SCENE_SEED,
                   n_frames=LONG_FRAMES, max_keyframes=LONG_WINDOW,
                   max_factors=64)
    df = r["df"]
    m = df.mapper
    assert df.n_lost_frames == 0 and r["tracked"] == 1.0, "frames lost"
    assert df.n_evictions >= 10, f"only {df.n_evictions} evictions"
    assert df.n_evictions == m._next_kid - LONG_WINDOW == len(r["evicted"]), \
        (df.n_evictions, m._next_kid, len(r["evicted"]))
    assert [a["id"] for a in m.archived] == r["evicted"], "archive incomplete"
    assert len(m.kf_slots) == LONG_WINDOW
    assert r["ate"] < LONG_ATE_BOUND_M, f"ATE {r['ate']} >= {LONG_ATE_BOUND_M}"

    before = launch_counts()
    t0 = time.perf_counter()
    dump = m.dump_state(verbose_errors=True)
    dump_ms = (time.perf_counter() - t0) * 1e3
    json.dumps(dump)
    kf_kf = [f for f in dump["photo_factors"] if not f["dst_is_frame"]]
    levels = {f["level"] for f in kf_kf}
    n_dump = launch_counts()["sfm_error_batch"] - before["sfm_error_batch"]
    assert kf_kf and n_dump == len(levels) > 0, (len(kf_kf), n_dump, levels)
    for f in kf_kf:
        assert np.isfinite(f["residual"]) and f["inliers"] > 0, f
    assert len(dump["archived"]) == df.n_evictions
    assert all(np.isfinite(a["q"]).all() and np.isfinite(a["t"]).all()
               for a in dump["archived"])
    assert len(dump["keyframes"]) == LONG_WINDOW
    n_prior = sum(k["has_marginal_prior"] for k in dump["keyframes"])

    # the current keyframe rendered into the last frame's view
    kf = df.curr_kf
    lvl0 = m.state.levels[0]
    pose_10 = se3m.relative_pose(
        SE3(torch.as_tensor(df.pose_wc.q, device=dev),
            torch.as_tensor(df.pose_wc.t, device=dev)),
        se3m.index(m.state.pose, kf))
    before = launch_counts()
    last = torch.as_tensor(r["frames"][-1], dtype=torch.float32, device=dev)
    warped, stats = ds.se3_warp(pose_10, r["cam"], lvl0.img[kf], last,
                                lvl0.dpt[kf])
    torch.cuda.synchronize()
    n_warp = launch_counts()["se3_warp_batch"] - before["se3_warp_batch"]
    res, inl = float(stats.residual), float(stats.inliers)
    assert n_warp == 1 and warped.shape == (H, W)
    assert torch.isfinite(warped).all() and np.isfinite(res)
    assert res > 0 and inl > 0, (res, inl)
    launches = launch_counts()
    log(f"long run dump: {len(kf_kf)} keyframe-to-keyframe factors at levels "
        f"{sorted(levels)} evaluated in {n_dump} sfm_error_batch launches, "
        f"{dump_ms:.1f} ms; {len(dump['archived'])} archived, {n_prior} of "
        f"{LONG_WINDOW} keyframes hold a marginal prior, "
        f"{len(dump['links'])} links; median residual per inlier "
        f"{np.median([f['residual'] / f['inliers'] for f in kf_kf]):.3e}")
    log(f"long run warp: keyframe {kf} into the last frame, {int(inl)} of "
        f"{H * W} pixels valid, mean squared residual {res / inl:.3e}")
    path = ("se3_gram_batch", "sfm_gram_batch", "sfm_error_batch",
            "se3_warp_batch")
    assert all(launches[k] > 0 for k in path), f"kernel not launched: {launches}"
    return launches


# ----------------------------------------------------------------------------
# phase 7: loop closure and relocalisation
# ----------------------------------------------------------------------------

def phase_loop(dev, decoder):
    """Phase 7: the flagship configuration (tools/bench_e2e.py's
    build_system: reprojection factors and loop closure on) on
    LOOP_FRAMES frames of random_room(LOOP_SCENE_SEED)."""
    # its frame latencies are reported: no part is timed between
    # synchronises (port_tools/facade_run.py --time-parts times them)
    r = run_facade(dev, decoder, "loop closure", scene_seed=LOOP_SCENE_SEED,
                   n_frames=LOOP_FRAMES, max_keyframes=32, max_factors=128,
                   use_reprojection=True, loop_closure=True, time_parts=False)
    launches = launch_counts()
    READINGS["loop_ms_by"] = r["ms_by"]
    df = r["df"]
    assert df.n_lost_frames == 0 and r["tracked"] == 1.0, "frames lost"
    counts = (df.n_local_links, df.n_live_global_loops, df.n_archived_loops)
    assert df.n_live_global_loops + df.n_archived_loops >= 1, \
        "no global loop accepted"
    assert counts == LOOP_COUNTS_JAX, \
        f"loop counters {counts}, the JAX facade's {LOOP_COUNTS_JAX}"
    # the live loop: its frame, and the link (current keyframe, target)
    assert len(r["loop_at"]) == 1, r["loop_at"]
    (frame, link), = r["loop_at"]
    at, src, dst = LOOP_AT_JAX
    assert abs(frame - at) <= LOOP_FRAME_TOL and link == str((src, dst)), \
        (r["loop_at"], LOOP_AT_JAX)
    # each dense verification: the candidates padded to loop_max_candidates,
    # one se3_gram_batch launch per GN iteration of the C2F schedule
    iters = sum(df.cfg.tracking_iterations)
    assert r["verifies"] and all(
        v["C"] == df.cfg.loop_max_candidates and v["launches"] == iters
        for v in r["verifies"]), r["verifies"]
    assert r["ate"] < LOOP_ATE_BOUND_M, f"ATE {r['ate']} >= {LOOP_ATE_BOUND_M}"
    path = ("se3_gram_batch", "sfm_gram_batch", "sfm_error_batch")
    assert all(launches[k] > 0 for k in path), f"kernel not launched: {launches}"
    return launches


def phase_reloc(dev, decoder):
    """Phase 7b: two noise frames in an orbit run with loop closure on and
    a window of RELOC_WINDOW keyframes: the frame after the first
    relocalises against the live pool, frame 0 after the second against the
    archive, resurrecting its keyframe."""
    from deepfactors_tpu_torch.utils import tum_io

    schedule = (list(range(3, RELOC_LIVE_AT)) + [-1]
                + list(range(RELOC_LIVE_AT, RELOC_FRAMES)) + [-1, 0, 1, 2])
    r = run_facade(dev, decoder, "relocalisation", scene_seed=LOOP_SCENE_SEED,
                   n_frames=RELOC_FRAMES, max_keyframes=RELOC_WINDOW,
                   max_factors=4 * RELOC_WINDOW, use_reprojection=True,
                   loop_closure=True, schedule=schedule,
                   tracking_error_threshold=RELOC_ERROR_THRESHOLD)
    launches = launch_counts()
    df = r["df"]
    assert df.n_evictions >= 1, "no keyframe was archived"
    assert df.n_lost_frames == 2 and df.n_relocalizations == 2, \
        (df.n_lost_frames, df.n_relocalizations, r["relocs"])
    ok = [x for x in r["relocs"] if x["ok"]]
    iters = sum(df.cfg.tracking_iterations)
    # the live pool: one verification at P = RELOC_WINDOW
    assert ok[0]["frame"] == RELOC_LIVE_AT and not ok[0]["resurrected"]
    assert ok[0]["launches"] == iters, ok[0]
    # the archive: the live pool fails, then one verification at P = 64,
    # and the archived keyframe is built again
    assert ok[1]["frame"] == 0 and ok[1]["resurrected"], ok[1]
    assert ok[1]["launches"] == 2 * iters, ok[1]
    # each relocalised frame's error after the trajectory's rigid alignment
    # (the ATE's); frame 0 also stands at the start of the trajectory, so
    # its last entry is the relocalised one
    est = df.trajectory
    err = tum_io.ate_errors(est, [(ts, r["poses"][int(ts)]) for ts, _ in est])
    stamps = [ts for ts, _ in est]
    errs = {}
    for f in (RELOC_LIVE_AT, 0):
        errs[f] = float(err[len(stamps) - 1 - stamps[::-1].index(float(f))])
        assert errs[f] < RELOC_POSE_BOUND_M, (f, errs[f])
    assert r["tracked"] < 1.0 and len(df.trajectory) == len(schedule) - 2 + 1
    log(f"relocalisation: live at frame {RELOC_LIVE_AT} and from the archive "
        f"at frame 0 (keyframe resurrected), error to the truth after the "
        f"rigid alignment {errs} m (bound {RELOC_POSE_BOUND_M}; median over "
        f"the run {float(np.nanmedian(err)):.4f} m); {df.n_evictions} "
        f"evictions")
    return launches


# ----------------------------------------------------------------------------
# phase 8: the pipelined facade on the bench's row
# ----------------------------------------------------------------------------

def upload_check(dev, frames):
    """Frames uploaded through ``frame_step.upload_frame`` (pinned staging,
    non-blocking copies) behind a spin kernel, each host array dropped at
    once: every device copy must equal its frame bit for bit, so the
    caching host allocator kept each pinned block until its copy ran.
    float32 and uint8 (widened on the device) uploads."""
    import torch
    from deepfactors_tpu_torch import frame_step as fs

    u8 = [(np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8) for f in frames]
    torch.cuda.synchronize()
    torch.cuda._sleep(PIPE_SPIN_CYCLES)
    outs = [fs.upload_frame(np.array(f), dev) for f in frames]
    outs += [fs.upload_frame(np.array(f), dev) for f in u8]
    torch.cuda.synchronize()
    want = list(frames) + [f.astype(np.float32) * np.float32(1.0 / 255.0)
                           for f in u8]
    for o, w in zip(outs, want):
        assert np.array_equal(o.cpu().numpy(), w), "pinned upload corrupted"
    return len(outs)


def run_pipelined(dev, decoder, tag, scene_seed=PIPE_SCENE_SEED,
                  n_frames=PIPE_FRAMES, depth=PIPE_DEPTH, audit=None,
                  ransac_draw=None, stop=None, trace=None, checks=True):
    """bench.py's end-to-end row through the port: the sequence of
    ``bench._render_seq`` (``orbit_trajectory(n_frames)``), ``bench_system``
    at ``pipeline_depth=depth``, ``prewarm()``, then bench.py's
    ``_run_e2e``: bootstrap on frames 0 and 2, PIPE_WARM frames,
    ``flush()``, the timed frames, ``flush()``, with a synchronise at both
    ends of the timed part. Sets the launch counts to 0 after the prewarm.
    With ``audit`` ("error" or "warn"; None: off) every dispatch of a timed
    frame but a relocalised one runs under
    ``torch.cuda.set_sync_debug_mode(audit)``: "error" raises at the first
    synchronising op, "warn" counts each synchronising call site (its
    Python stack) in the readings' ``sync_sites`` (the audit's own cost then
    falls inside ``e2e_fps`` and the frame latencies). The warm frames of
    PIPE_PROBE_FRAMES are dispatched behind a spin kernel, and the retire
    of each holds its pinned probe read to ``out.probe.cpu()`` bit for bit.
    ``checks=False`` leaves out the upload check and the probe check (their
    spin kernels would count as device work in a profile).
    ``stop`` cuts the run after frame stop - 1 (a rehearsal on the CPU; the
    sequence's pacing stays that of ``n_frames``). ``trace``: a file for
    port_tools/decision_trace.py's per-frame trace. Returns the facade and
    the run's readings."""
    import torch
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.tools.bench_config import bench_system
    from deepfactors_tpu_torch.utils import tum_io

    cuda = dev != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    warm = PIPE_WARM
    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    scene = synth.random_room(scene_seed, n_boxes=3)
    poses = synth.orbit_trajectory(n_frames)
    frames = synth.render_sequence(scene, cam, poses, H, W, device=dev)
    df = bench_system(cam, decoder, dev, pipeline_depth=depth)
    if ransac_draw is not None:
        df.mapper.ransac_draw = ransac_draw
    t = time.perf_counter()
    df.prewarm()
    prewarm_s = time.perf_counter() - t
    n_uploads = upload_check(dev, frames[:4]) if cuda and checks else 0

    # the probe check: the retire's parsed probe against the device probe
    probe_pairs = []
    parse, retire = df._parse_probe, df._retire_one

    def checked_retire():
        e, seen = df._pending[0], []
        if int(e.timestamp) not in PIPE_PROBE_FRAMES:
            return retire()

        def seen_parse(pv):
            seen.append(np.array(pv, copy=True))
            return parse(pv)
        df._parse_probe = seen_parse
        try:
            retire()
        finally:
            df._parse_probe = parse
        if seen:
            probe_pairs.append((seen[0], e.out.probe))

    # the sync audit around each dispatch
    dispatch = df._dispatch_frame
    audited = [0]
    sync_sites: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        site = "".join(traceback.format_stack(limit=10)[:-1])
        sync_sites[site] = sync_sites.get(site, 0) + 1

    def audited_dispatch(img, just_relocalized=False):
        if just_relocalized:
            return dispatch(img, just_relocalized)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(audit)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                out = dispatch(img, just_relocalized)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        audited[0] += 1
        return out

    # every dense verification of a global-loop candidate set: the frame
    # fed when it ran and its packed result (read after the run)
    verifies, frame_no = [], [0]
    if df.loop_detector is not None:
        verify = df.loop_detector._verify

        def logged_verify(*a):
            out = verify(*a)
            verifies.append((frame_no[0], out))
            return out
        df.loop_detector._verify = logged_verify
    kf_at = []       # frames fed at whose call a keyframe was built

    reset_launch_counts()
    sync()
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    close_trace = None
    if trace:
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "port_tools"))
        import decision_trace
        close_trace = decision_trace.attach(df, trace)
    df.trajectory = [(0.0, df.pose_wc)]
    probing = cuda and checks and depth > 0
    if probing:
        df._retire_one = checked_retire
    for i in range(3, 3 + warm):
        if probing and i in PIPE_PROBE_FRAMES:
            torch.cuda._sleep(PIPE_SPIN_CYCLES)
        frame_no[0], n_kf = i, df.mapper._next_kid
        df.process_frame(float(i), frames[i])
        if df.mapper._next_kid > n_kf:
            kf_at.append(i)
    df.flush()
    df._retire_one = retire
    for pv, dev_probe in probe_pairs:
        ref = dev_probe.cpu().numpy()
        assert np.array_equal(pv.view(np.uint32), ref.view(np.uint32)), \
            "a pinned probe read differs from out.probe.cpu()"
    if cuda and audit:
        df._dispatch_frame = audited_dispatch
    ms_by = {"tracking-only frames": [], "one-way-frame events": [],
             "keyframe events": []}
    n_frames_enq = int(df.mapper.frames.next_id)
    loop_at, ms_at = [], []
    stop = n_frames if stop is None else stop
    sync()
    t0 = time.perf_counter()
    for i in range(3 + warm, stop):
        n_kf, n_links = df.mapper._next_kid, len(df.loop_links)
        frame_no[0] = i
        t1 = time.perf_counter()
        df.process_frame(float(i), frames[i])
        dt = (time.perf_counter() - t1) * 1e3
        n_fr = int(df.mapper.frames.next_id)
        kind = ("keyframe events" if df.mapper._next_kid > n_kf else
                "one-way-frame events" if n_fr > n_frames_enq else
                "tracking-only frames")
        n_frames_enq = n_fr
        ms_by[kind].append(dt)
        ms_at.append((i, kind, dt))
        if kind == "keyframe events":
            kf_at.append(i)
        loop_at += [(i, str(link)) for link in df.loop_links[n_links:]]
    df.flush()
    sync()
    timed_s = time.perf_counter() - t0
    df._dispatch_frame = dispatch
    if close_trace is not None:
        close_trace()
    verified = []
    for f, out in verifies:
        pk = out.cpu().numpy()
        verified.append((f, [round(float(x), 4) for x in pk[:, 7]],
                         [round(float(x), 4) for x in
                          np.linalg.norm(pk[:, 4:7], axis=-1)]))
    est = df.trajectory
    for _, p in est:
        assert np.isfinite(p.q).all() and np.isfinite(p.t).all(), \
            "non-finite pose"
    gt = [(ts, poses[int(ts)]) for ts, _ in est]
    ate = tum_io.ate_rmse(est, gt)
    tracked = 1.0 - df.n_lost_frames / max(df.n_frames, 1)
    e2e_fps = (stop - 3 - warm) / timed_s
    loops = (df.n_local_links, df.n_live_global_loops, df.n_archived_loops)
    log(f"{tag}: prewarm {prewarm_s:.2f} s; {df.n_frames} frames after the "
        f"bootstrap, e2e_fps {e2e_fps:.2f} (bench.py's definition: frames "
        f"{3 + warm}-{stop - 1}, {timed_s:.2f} s between two flushes "
        f"and synchronises); {n_uploads} pinned uploads checked, "
        f"{len(probe_pairs)} pinned probe reads bit-identical, "
        f"{audited[0]} dispatches under the sync audit")
    for kind, v in ms_by.items():
        log(f"{tag} {kind} (host ms a call, no synchronise): {stat(v)}")
    log(f"{tag} keyframes built {df.mapper._next_kid}, live "
        f"{len(df.mapper.kf_slots)}, evicted {df.n_evictions}, tracked "
        f"fraction {tracked:.4f}, lost {df.n_lost_frames}, trajectory "
        f"{len(est)}, pending {len(df._pending)}, loops {loops} at "
        f"{loop_at}, relocalisations {df.n_relocalizations}, rigid ATE "
        f"{ate:.4f} m; kernel launches {launch_counts()}")
    log(f"{tag} keyframes built at frames fed {kf_at}")
    log(f"{tag} dense verifications (frame fed, inlier shares, translations "
        f"m): {verified}")
    for site, n in sync_sites.items():
        log(f"{tag} synchronising call site, {n} times:\n{site}")
    return dict(df=df, ate=ate, tracked=tracked, e2e_fps=e2e_fps,
                ms_by=ms_by, audited=audited[0], probe_checks=len(probe_pairs),
                uploads=n_uploads, loops=loops, loop_at=loop_at,
                prewarm_s=prewarm_s, sync_sites=sync_sites, poses=poses,
                ms_at=ms_at,
                kf_at=kf_at, verified=verified)


def phase_pipelined(dev, decoder):
    """Phase 8: the pipelined facade (pipeline_depth=1) on bench.py's
    end-to-end row, held to the JAX facade's run of it; then the sync audit
    in a shorter pass of its own, and the row of another room for an
    archived loop."""
    r = run_pipelined(dev, decoder, "pipelined")
    launches = launch_counts()
    df = r["df"]
    assert df.n_lost_frames == 0 and r["tracked"] == 1.0, "frames lost"
    assert len(df._pending) == 0, "flush left frames in flight"
    assert df.n_frames == PIPE_JAX["n_frames"], df.n_frames
    assert len(df.trajectory) == PIPE_JAX["trajectory"], len(df.trajectory)
    assert r["ate"] < PIPE_ATE_BOUND_M, f"ATE {r['ate']} >= {PIPE_ATE_BOUND_M}"
    # global-loop candidates were retrieved and verified densely (JAX's
    # runs verify from frame ~140 on, under every key seed)
    assert r["verified"], "no dense verification of a loop candidate"
    assert r["probe_checks"] == len(PIPE_PROBE_FRAMES), r["probe_checks"]
    path = ("se3_gram_batch", "sfm_gram_batch", "sfm_error_batch")
    assert all(launches[k] > 0 for k in path), f"kernel not launched: {launches}"
    a = run_pipelined(dev, decoder, "pipelined, sync audit", audit="error",
                      stop=PIPE_AUDIT_STOP, checks=False)
    n_track = len(a["ms_by"]["tracking-only frames"])
    assert a["audited"] >= PIPE_AUDIT_MIN and n_track >= PIPE_AUDIT_MIN, \
        (a["audited"], n_track)
    assert a["df"].n_lost_frames == 0, "frames lost in the audited pass"
    track = lambda x: [dt for i, k, dt in x["ms_at"]
                       if k == "tracking-only frames" and i < PIPE_AUDIT_STOP]
    log(f"tracking-only frames 13-{PIPE_AUDIT_STOP - 1}, host ms: without "
        f"the audit {stat(track(r))}; with it {stat(track(a))}")
    g = run_pipelined(dev, decoder, f"pipelined, room {PIPE_LOOP_SCENE_SEED}",
                      scene_seed=PIPE_LOOP_SCENE_SEED, checks=False)
    assert g["tracked"] == 1.0, f"room {PIPE_LOOP_SCENE_SEED}: frames lost"
    assert g["loops"][2] >= 1, f"no archived loop: {g['loops']}"
    log(f"pipelined: loop counters {r['loops']} (the JAX facade's run "
        f"{PIPE_JAX['loops']}), keyframes built {df.mapper._next_kid} "
        f"({PIPE_JAX['keyframes_built']}), evictions {df.n_evictions} "
        f"({PIPE_JAX['evictions']}), rigid ATE {r['ate']:.4f} m "
        f"({PIPE_JAX['ate']}; bound {PIPE_ATE_BOUND_M})")
    seq = READINGS.get("loop_ms_by")
    if seq is not None:
        log("tracking-only frames, host ms: pipelined (phase 8, no "
            "synchronise) " + stat(r["ms_by"]["tracking-only frames"])
            + "; sequential (phase 7, a synchronise after each frame) "
            + stat(seq["tracking-only frames"]) + f"; {smi_line()}")
    return launches


# ----------------------------------------------------------------------------
# phase 6: the parallel/ entry points on one card
# ----------------------------------------------------------------------------

def _relative_to_first(poses, dev):
    """Host SE3 poses as a batched device SE3 relative to the first."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.se3 import SE3
    p = SE3(torch.tensor(np.stack([x.q for x in poses]), device=dev),
            torch.tensor(np.stack([x.t for x in poses]), device=dev))
    first = se3m.index(p, slice(0, 1))
    return se3m.mul(se3m.inverse(first), p)


def _smoke_camera():
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    return PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                                width=W, height=H)


def phase_dryrun(dev):
    """6a: the dry-run BA step through its entry point, then its system
    (H, b) through the kernels against the same system with
    ``dense_warp_batch`` and ``jacobian_stack`` replaced by their plain
    twins, on the card, at poses moved off the identity so that no block is
    zero."""
    import torch
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
    from deepfactors_tpu_torch.ops.kernels import jacobian_stack as js
    from deepfactors_tpu_torch.parallel import dist_ba, dryrun

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q, t, c = dryrun.dryrun_single(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    K, CS = dryrun.K, dryrun.CS
    assert q.shape == (K, 4) and t.shape == (K, 3) and c.shape == (K, CS)
    assert np.abs(t).max() > 1e-4, "the step did not move a pose"
    launches = launch_counts()
    assert launches["dense_warp_batch"] == 1, launches
    assert launches["jacobian_stack"] == 1, launches

    cam, params, fd, q0, t0_, c0, active = dryrun.dryrun_problem(dev)
    moved = perturb(SE3(q0, t0_), seed=61)
    g = torch.Generator(device="cpu").manual_seed(62)
    codes = (0.1 * torch.randn((K, CS), generator=g)).to(dev)
    system = lambda: dist_ba.local_system(moved.q, moved.t, codes, fd, K, CS,
                                          cam, params)
    Hk, bk, sk = system()
    kernels = dw.dense_warp_batch, js.jacobian_stack
    dw.dense_warp_batch = dw.dense_warp_batch_plain
    js.jacobian_stack = js.jacobian_stack_plain
    try:
        Hp, bp, sp = system()
    finally:
        dw.dense_warp_batch, js.jacobian_stack = kernels
    torch.cuda.synchronize()
    assert launch_counts()["dense_warp_batch"] == 2, launch_counts()
    assert launch_counts()["jacobian_stack"] == 2, launch_counts()
    Dp = 6 * K
    blocks = {"H pose-pose": (Hk[:Dp, :Dp], Hp[:Dp, :Dp]),
              "H pose-code": (Hk[:Dp, Dp:], Hp[:Dp, Dp:]),
              "H code-code": (Hk[Dp:, Dp:], Hp[Dp:, Dp:]),
              "b pose": (bk[:Dp], bp[:Dp]), "b code": (bk[Dp:], bp[Dp:]),
              "residual": (sk[:1], sp[:1])}
    errs = {}
    for name, (a, b) in blocks.items():
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0, name
        errs[name] = float((a - b).abs().max() / b.abs().max())
        assert errs[name] < DRYRUN_TOL, f"dry run {name}: {errs[name]}"
    assert float(sk[1]) == float(sp[1]) > 0, "inlier counts differ"
    log(f"dry run (K={K}, CS={CS}, {fd.src.shape[0]} factors, {H}x{W}): one "
        f"step {step_ms:.1f} ms with the problem's set-up, max |dt| "
        f"{np.abs(t).max():.3e}; kernel vs twins per block "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {DRYRUN_TOL}), inliers equal")
    return launches           # the entry point's, without the comparison's


def large_map_setup(dev, decoder):
    """The large map of ``LARGE``: 32 decoded keyframes of the room orbit,
    links to the last four both ways, perturbed poses."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.ops import image as ip
    from deepfactors_tpu_torch.parallel import large_map

    c = LARGE
    K, CS = c["K"], decoder.cfg.code_size
    cam = _smoke_camera()
    scene = synth.random_room(c["scene_seed"], n_boxes=3)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)
    poses = poses[::c["stride"]][:K]
    images = torch.tensor(np.stack(synth.render_sequence(
        scene, cam, poses, H, W, device=dev)), device=dev)
    prx0, jac, std = [], [], []
    for im in images:
        out = decoder.raw_outputs_T(im)
        # the predicted code folded into the zero-code proximity, as the
        # mapper does at keyframe build
        prx0.append(out["prx0"][0] + torch.einsum(
            "chw,c->hw", out["jac"][0], out["code_pred"]))
        jac.append(out["jac"][0].permute(1, 2, 0))
        std.append(out["stdev"][0])
    true = _relative_to_first(poses, dev)
    poses0 = se3m.retract(true, torch.tensor(large_map_noise(), device=dev))
    links = large_map_links()
    problem = large_map.build_problem(
        images, torch.stack(prx0), torch.stack(jac), torch.stack(std),
        ip.sobel_gradients(images), poses0,
        torch.zeros((K, CS), device=dev), links)
    assert problem.fd.src.shape[0] == 2 * len(links)
    return dict(cam=cam, problem=problem, true=true, poses0=poses0)


def large_map_run(setup):
    """6b: ``LargeMapBA`` on the large map, then one ``sfm_step`` on one of
    its factors (bilinear_warp_planes) against the same factor of
    ``sfm_step_batch`` (dense_warp_batch)."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.parallel import large_map

    c = LARGE
    cam, problem, true, poses0 = (setup[k] for k in ("cam", "problem", "true",
                                                     "poses0"))
    K, CS = problem.codes.shape
    P = problem.fd.src.shape[0]
    params = ds.SfmParams(**LARGE_SFM)
    ba = large_map.LargeMapBA(K, CS, cam, params)

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, codes, hist = ba.run(problem, iters=c["iters"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    chunk = ds._JT_CHUNK_BYTES // ((12 + CS) * H * W * 4)
    n_chunks = -(-P // chunk)
    assert launches["dense_warp_batch"] == c["iters"] * n_chunks, launches
    assert launches["jacobian_stack"] == c["iters"] * n_chunks, launches
    hist = torch.stack(hist).cpu().numpy()
    err = lambda p: se3m.local(true, p)[:, :3].norm(dim=-1).cpu().numpy()
    e0, e1 = err(poses0), err(est)
    rmse0, rmse1 = (float(np.sqrt((e ** 2).mean())) for e in (e0, e1))
    rpi = hist[:, 0] / hist[:, 1]
    # the decoder's depth carries a scale bias that a monocular BA cannot
    # see: the error left after one scale factor on the translations
    scale = float((est.t * true.t).sum() / (est.t * est.t).sum())
    rmse_s = float((scale * est.t - true.t).pow(2).sum(dim=1).mean().sqrt())
    assert torch.isfinite(est.q).all() and torch.isfinite(est.t).all()
    assert torch.isfinite(codes).all() and np.isfinite(hist).all()
    log(f"large map: K={K}, {P} factors ({n_chunks} chunks of <= {chunk}), "
        f"{c['iters']} iterations in {wall:.2f} s "
        f"({1e3 * wall / c['iters']:.1f} ms each), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"large map: keyframe translation error rmse {rmse0:.4f} -> "
        f"{rmse1:.4f} m, max {e0.max():.4f} -> {e1.max():.4f} m; after one "
        f"scale factor {scale:.4f} on the translations {rmse_s:.4f} m; residual per "
        f"inlier by iteration {[round(float(x), 6) for x in rpi]}; inliers "
        f"{int(hist[0, 1])} -> {int(hist[-1, 1])}; max |code| "
        f"{float(codes.abs().max()):.3f}")
    assert rpi[-1] < LARGE_RPI_BOUND, f"residual per inlier {rpi[-1]}"
    assert rmse1 < LARGE_ERR_BOUND_M, f"keyframe error {rmse1} m"

    # one factor through sfm_step (bilinear_warp_planes) and through
    # sfm_step_batch (dense_warp_batch): two kernels, one system
    fd = problem.fd
    p = P // 2
    s, d = int(fd.src[p]), int(fd.dst[p])
    code0 = codes[s]
    dpt0 = params.avg_dpt / (fd.prx0[p] + torch.einsum(
        "hwc,c->hw", fd.jac0[p], code0)) - params.avg_dpt
    one = slice(p, p + 1)
    before = launch_counts()
    sys1, valid0 = ds.sfm_step(
        se3m.index(est, s), se3m.index(est, d), code0, cam, fd.img0[p],
        fd.img1[p], dpt0, fd.std0[p], fd.jac0[p], fd.grad1[p], params)
    sysb = ds.sfm_step_batch(
        se3m.index(est, slice(s, s + 1)), se3m.index(est, slice(d, d + 1)),
        code0[None], cam, fd.img0[one], fd.img1[one], dpt0[None],
        fd.std0[one], fd.jac0[one], fd.grad1[one], params)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["bilinear_warp_planes"] - before["bilinear_warp_planes"] == 1
    assert after["dense_warp_batch"] - before["dense_warp_batch"] == 1
    assert after["jacobian_stack"] - before["jacobian_stack"] == 1
    assert float(sys1.inliers) == float(sysb.inliers[0]) == float(valid0.sum()) > 0
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    e_jtj, e_jtr = rel(sys1.JtJ, sysb.JtJ[0]), rel(sys1.Jtr, sysb.Jtr[0])
    assert e_jtj < KERNEL_TOL and e_jtr < KERNEL_TOL, (e_jtj, e_jtr)
    log(f"sfm_step (bilinear_warp_planes) vs sfm_step_batch "
        f"(dense_warp_batch) on factor {s}->{d}: JtJ {e_jtj:.2e}, Jtr "
        f"{e_jtr:.2e} (tol {KERNEL_TOL}), {int(sys1.inliers)} inliers")
    # the BA run's launches and sfm_step's one, without the comparison's
    return dict(launches, bilinear_warp_planes=1)


def odometry_setup(dev):
    """The rooms of ``ODO`` rendered along the slow orbit: frames
    [n + 1, S, H, W], the first frames' true depth, the true translations."""
    import torch
    from deepfactors_tpu_torch.io import synth

    c = ODO
    cam = _smoke_camera()
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=c["sweep"])[:c["frames"] + 1]
    true_t = _relative_to_first(poses, dev).t
    frames, depth0 = [], []
    for seed in c["scene_seeds"]:
        imgs, dpts = synth.render_sequence(
            synth.random_room(seed, n_boxes=3), cam, poses, H, W,
            with_depth=True, device=dev)
        frames.append(np.stack(imgs))
        depth0.append(dpts[0])
    return dict(cam=cam, true_t=true_t,
                frames=torch.tensor(np.stack(frames, axis=1), device=dev),
                depth0=torch.tensor(np.stack(depth0), device=dev))


def odometry_run(setup, group=None):
    """6c: ``BatchedOdometry`` over the rooms of ``ODO`` in lockstep (13d:
    with ``group``, this rank's block of the rooms, the poses gathered).
    Returns the launch counts and the poses [n, S, 7] (q, t) on the host."""
    import torch
    from deepfactors_tpu_torch.parallel import multi_seq

    c = ODO
    cam, true_t, frames = setup["cam"], setup["true_t"], setup["frames"]
    n, S = frames.shape[0] - 1, frames.shape[1]
    sync = torch.cuda.synchronize if frames.is_cuda else (lambda: None)
    odo = multi_seq.BatchedOdometry(
        cam, levels=c["levels"], iters_per_level=c["iters_per_level"],
        huber=c["huber"], kf_dist_threshold=c["kf_dist"], group=group)
    reset_launch_counts()
    state = odo.init(frames[0], setup["depth0"])
    errs, switches, ms, poses = [], [], [], []
    for i in range(1, n + 1):
        sync()
        t0 = time.perf_counter()
        state, pose_wc, sw = odo.process(state, frames[i])
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        assert torch.isfinite(pose_wc.q).all() and torch.isfinite(pose_wc.t).all()
        errs.append((pose_wc.t - true_t[i]).norm(dim=-1))
        switches.append(sw)
        poses.append(torch.cat([pose_wc.q, pose_wc.t], dim=-1))
    launches = launch_counts()
    if frames.is_cuda:
        assert launches["se3_gram_batch"] == n * sum(c["iters_per_level"]), \
            launches
    errs = torch.stack(errs)
    rmse = errs.pow(2).mean(dim=0).sqrt().cpu().numpy()
    n_sw = torch.stack(switches).sum(dim=0).cpu().numpy()
    path = float((true_t[1:] - true_t[:-1]).norm(dim=-1).sum())
    r4 = lambda a: [round(float(x), 4) for x in a]
    log(f"odometry: {S} scenes x {n} frames"
        + (f" over {odo.world} ranks (this one {odo.rank}, P = "
           f"{S // odo.world})" if group is not None else "")
        + f", {stat(ms)} per lockstep frame; translation rmse per scene "
        f"{r4(rmse)} m over a path of {path:.3f} m, final error "
        f"{r4(errs[-1])} m, keyframe switches per scene {n_sw.tolist()}")
    assert (n_sw >= 1).all(), "a scene never switched its keyframe"
    assert rmse.max() < ODO_RMSE_BOUND_M, f"odometry rmse {rmse}"
    return launches, torch.stack(poses).cpu().numpy()


# ----------------------------------------------------------------------------
# phase 9: geometric factors and depth priors
# ----------------------------------------------------------------------------

def refine_config():
    """The refinement configuration of phase 9 (see REFINE_FLAGFILE)."""
    from deepfactors_tpu_torch import config

    cfg = config.build_system_config(config.parse_args(
        [f"--flagfile={REFINE_FLAGFILE}", *REFINE_OVERRIDES]), H, W)
    m = cfg.mapper
    return cfg._replace(mapper=m._replace(
        max_geo_factors=m.max_keyframes * m.max_back_connections + 16))


def phase_refine(dev, decoder):
    """Phase 9: the facade in the reference's refinement configuration on
    REFINE_FRAMES frames of random_room(REFINE_SCENE_SEED), sequential."""
    from collections import Counter

    from deepfactors_tpu_torch.solver import system as sysm

    cfg = refine_config()
    assert cfg.mapper.use_geometric and not cfg.mapper.use_schur
    solves = {"dense": 0, "schur": 0}
    draws = []          # the keyframe id being built at each geo draw

    def counting(kind, fn):
        def wrapped(*a):
            solves[kind] += 1
            return fn(*a)
        return wrapped

    def setup(df):
        m = df.mapper
        draw = m.geo_draw

        def counting_draw(*a):
            draws.append(m._next_kid - 1)
            return draw(*a)

        m.geo_draw = counting_draw

    dense, schur = sysm.solve_damped, sysm.solve_schur_codes
    sysm.solve_damped = counting("dense", dense)
    sysm.solve_schur_codes = counting("schur", schur)
    try:
        r = run_facade(dev, decoder, "refine", scene_seed=REFINE_SCENE_SEED,
                       n_frames=REFINE_FRAMES,
                       max_keyframes=cfg.mapper.max_keyframes,
                       max_factors=cfg.mapper.max_factors, system_cfg=cfg,
                       time_parts=False, setup=setup)
    finally:
        sysm.solve_damped, sysm.solve_schur_codes = dense, schur
    launches = launch_counts()
    df = r["df"]
    m = df.mapper
    assert df.n_lost_frames == 0 and r["tracked"] == 1.0, "frames lost"
    # geometric factors at every keyframe event (one draw per
    # back-connection), into the pool and assembled into the GN iterations
    per_event = Counter(draws)
    events = list(range(2, m._next_kid))
    assert events and all(per_event[k] >= 1 for k in events), \
        (events, per_event)
    n_geo = int(m.geo_pool.active.sum())
    assert n_geo > 0, "no geo factor live"
    gs = m.geo_stats
    assert gs["iterations"] > 0 and gs["factor_terms"] > gs["iterations"], gs
    # the dense solve: a geometric factor couples two keyframes' codes
    assert solves["schur"] == 0 and solves["dense"] > 0, solves
    path = ("se3_gram_batch", "sfm_gram_batch", "sfm_error_batch")
    assert all(launches[k] > 0 for k in path), f"kernel not launched: {launches}"
    assert r["ate"] < REFINE_ATE_BOUND_M, \
        f"ATE {r['ate']} >= {REFINE_ATE_BOUND_M}"
    loops = (df.n_local_links, df.n_live_global_loops, df.n_archived_loops)
    log(f"refine: {REFINE_FLAGFILE} with {list(REFINE_OVERRIDES)}, "
        f"geo pool {cfg.mapper.max_geo_factors}; keyframes built "
        f"{m._next_kid} (JAX {REFINE_JAX['keyframes_built']}), evictions "
        f"{df.n_evictions} ({REFINE_JAX['evictions']}), loops {loops} "
        f"({REFINE_JAX['loops']}), rigid ATE {r['ate']:.4f} m "
        f"({REFINE_JAX['ate']}; bound {REFINE_ATE_BOUND_M})")
    log(f"refine: geo draws per keyframe event {[per_event[k] for k in events]}"
        f"; geo factors live {n_geo} (JAX {REFINE_JAX['geo_live']}), rep "
        f"{int(m.rep_pool.active.sum())} ({REFINE_JAX['rep_live']}); GN "
        f"iterations assembling geo factors {gs['iterations']} "
        f"({gs['factor_terms']} factor terms, "
        f"{gs['factor_terms'] / gs['iterations']:.1f} an iteration); solves "
        f"{solves}; {smi_line() if dev != 'cpu' else 'cpu'}")
    return launches


def _geo_inputs(dev):
    """Phase 9a's inputs on ``dev``: GEO_FACTORS factors between neighbouring
    rendered room views (slot p -> p + 1, pose 0 perturbed), their decode
    pools (prox of the rendered depth, a random CS-32 Jacobian, codes), the
    Sobel gradients of the decoded depths, GEO_POINTS points a factor."""
    import torch
    from deepfactors_tpu_torch.features.sampler import sample_uniform_pixels
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry import warping as wp
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops import image as ip

    P, N = GEO_FACTORS, GEO_POINTS
    cam, levels, q, t, codes = make_pools(dev, K=P + 1)
    lv = levels[0]
    prx0 = wp.depth_to_prox(lv["dpt"], 2.0)
    jac = lv["jac"]
    dpt = wp.prox_to_depth(torch.clamp(
        prx0 + torch.einsum("kchw,kc->khw", jac, codes), min=1e-4), 2.0)
    dgrad = ip.sobel_gradients(dpt).contiguous()
    src = torch.arange(P, device=dev)
    dst = src + 1
    pose = SE3(q, t)
    pose0 = perturb(se3m.index(pose, src), seed=9)
    pose1 = se3m.index(pose, dst)
    g = torch.Generator().manual_seed(5)
    pts = torch.stack([sample_uniform_pixels(N, W, H, 1, g)
                       for _ in range(P)]).to(dev)
    return cam, dict(pose0=pose0, pose1=pose1, code0=codes[src],
                     code1=codes[dst], points=pts, prx0=prx0, jac=jac,
                     dgrad=dgrad, src=src, dst=dst)


def _geo_call(cam, a, fn="system"):
    from deepfactors_tpu_torch.ops import sparse_factors as sf
    if fn == "system":
        return sf.geometric_system(
            a["pose0"], a["pose1"], a["code0"], a["code1"], cam, a["points"],
            a["prx0"], a["jac"], a["prx0"], a["jac"], a["dgrad"],
            huber_delta=0.1, avg_dpt=2.0, src=a["src"], dst=a["dst"])
    return sf._geo_warp(a["pose0"], a["pose1"], a["code0"], a["code1"], cam,
                        a["points"], a["prx0"], a["jac"], a["prx0"], a["jac"],
                        2.0, a["src"], a["dst"], border=1, min_dpt=0.0)


def phase_geo_system(dev):
    """Phase 9a: ``geometric_system`` (plain PyTorch, no kernel of its own)
    on the card against the CPU at the refinement path's shapes; timed."""
    import torch
    from deepfactors_tpu_torch.geometry import camera as cm
    from deepfactors_tpu_torch.geometry.se3 import SE3

    cam, a = _geo_inputs(dev)
    cpu = {k: (SE3(v.q.cpu(), v.t.cpu()) if isinstance(v, SE3) else v.cpu())
           for k, v in a.items()}
    sd, sc = _geo_call(cam, a), _geo_call(cam, cpu)
    *_, corr_d, _, _ = _geo_call(cam, a, "warp")
    *_, corr_c, _, _ = _geo_call(cam, cpu, "warp")
    pd, pc = corr_d.pix1.cpu(), corr_c.pix1
    vd = (corr_d.valid & cm.pixel_valid(cam, corr_d.pix1)).cpu()
    vc = corr_c.valid & cm.pixel_valid(cam, corr_c.pix1)
    near = ((pc - pc.round()).abs() < GEO_ROUNDOFF_PX).any(-1)
    mask_flips = vd != vc
    lookup_flips = (pd.to(torch.int64) != pc.to(torch.int64)).any(-1) & vc
    assert not (mask_flips & ~near).any(), "validity differs off round-off"
    assert not (lookup_flips & ~near).any(), "lookup differs off round-off"
    clean = ~(mask_flips | lookup_flips).any(-1)        # [P] factors
    assert int(clean.sum()) >= GEO_FACTORS // 2, clean
    CS = a["code0"].shape[-1]
    edges = np.cumsum([0, 6, 6, CS, CS])
    worst = 0.0
    for p in np.nonzero(clean.numpy())[0]:
        for i in range(4):
            r = slice(edges[i], edges[i + 1])
            b = sc.Jtr[p, r]
            worst = max(worst, float((sd.Jtr[p, r].cpu() - b).abs().max()
                                     / b.abs().max().clamp(min=1e-30)))
            for j in range(4):
                c = slice(edges[j], edges[j + 1])
                b = sc.JtJ[p, r, c]
                worst = max(worst, float(
                    (sd.JtJ[p, r, c].cpu() - b).abs().max()
                    / b.abs().max().clamp(min=1e-30)))
    res = float(((sd.residual.cpu() - sc.residual).abs()
                 / sc.residual.abs().clamp(min=1e-30))[clean].max())
    assert worst < GEO_SYS_TOL and res < GEO_SYS_TOL, (worst, res)
    assert torch.equal(sd.inliers.cpu()[clean], sc.inliers[clean])
    assert torch.isfinite(sd.JtJ).all() and float(sc.residual.sum()) > 0
    # no synchronising op in a call (every GN iteration makes one)
    if dev != "cpu":
        torch.cuda.set_sync_debug_mode("error")
        try:
            _geo_call(cam, a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _geo_call(cam, a)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    dev_us, n_kernels = device_kernel_time(lambda: _geo_call(cam, a))
    log(f"geo system: {GEO_FACTORS} factors x {GEO_POINTS} points, CS {CS}, "
        f"{H}x{W}: card vs CPU, worst block {worst:.2e}, error sum "
        f"{res:.2e} (tolerance {GEO_SYS_TOL}); valid points "
        f"{int(vc.sum())} of {vc.numel()}; within {GEO_ROUNDOFF_PX} px of "
        f"an integer {int(near.sum())}, validity flips "
        f"{int(mask_flips.sum())}, lookup flips {int(lookup_flips.sum())}, "
        f"factors compared {int(clean.sum())}; a call: host "
        f"{np.median(host):.3f} ms (synchronised), device "
        + (f"{dev_us / 1e3:.3f} ms in {n_kernels} kernels (torch.profiler)"
           if dev_us is not None else "not measured")
        + (f", no synchronising op; {smi_line()}" if dev != "cpu"
           else "; cpu"))


def device_kernel_time(fn):
    """(device µs, kernel count) of one call of ``fn``: the durations of the
    CUDA kernels torch.profiler records, summed (``tools/common.
    kernel_time``); (None, None) on a CPU rehearsal. CUDA events around
    back-to-back calls do not time a call of hundreds of small launches:
    the launch queue fills behind a spin kernel, and the device then waits
    on the host."""
    import torch
    if not torch.cuda.is_available():
        return None, None
    from deepfactors_tpu_torch.tools.common import kernel_time
    return kernel_time(fn)


def depth_prior_run(dev, pho_iters=(6, 6), max_steps=None):
    """tests/test_mapper.py:174's scenario at H x W on ``dev``: two keyframes
    of one image at the identity with a flat synthetic decode (prx = 0.5 +
    0.1 code[0], CS 2, 2 levels), both tied to a depth of 2.5 m (sigma 0.05,
    code prior sigma 100), mapped until the work queue drains or for
    ``max_steps`` mapping steps. Returns the mean absolute error of keyframe
    0's decoded level-0 depth to the target before and after, the steps and
    keyframe 0's first code entry."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.mapping.mapper import Mapper, MapperConfig
    from deepfactors_tpu_torch.ops import image as ip

    CS2, target_dpt = 2, 2.5
    cfg = MapperConfig(
        max_keyframes=2, max_frames=1, max_factors=4, code_size=CS2,
        height=H, width=W, pyramid_levels=2, pho_iters=pho_iters,
        huber_delta=0.3, connection_mode="LASTN", max_back_connections=1,
        lm_lambda=1e-4, use_schur=False, use_depth_prior=True,
        dpt_prior_sigma=0.05, code_prior=100.0)
    cam = PinholeCamera.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = torch.tensor(0.5 + 0.2 * np.sin(xs / 5) * np.cos(ys / 4),
                       dtype=torch.float32, device=dev)
    m = Mapper(cfg, cam, device=dev)
    img_pyr = tuple(ip.build_pyramid(img, 2))
    grad_pyr = tuple(ip.build_gradient_pyramid(img_pyr))
    prx0 = tuple(torch.full_like(im, 0.5) for im in img_pyr)
    jac = tuple(torch.stack([torch.full_like(im, 0.1), torch.zeros_like(im)])
                for im in img_pyr)
    stdev = tuple(torch.zeros_like(im) for im in img_pyr)
    pyramids = (img_pyr, grad_pyr, prx0, jac, stdev,
                torch.zeros(CS2, device=dev))
    p0 = se3m.identity(device=dev)
    s0 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    s1 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    m._anchor_pose = p0
    m._add_photo_pair(s0, s1)
    target = np.full((H, W), target_dpt, np.float32)
    m.set_depth_prior(s0, target)
    m.set_depth_prior(s1, target)
    err = lambda: float((m.state.levels[0].dpt[s0] - target_dpt).abs().mean())
    before = err()
    steps = 0
    while m.has_work() and (max_steps is None or steps < max_steps):
        m.mapping_step()
        steps += 1
    m.update_map()
    return dict(before=before, after=err(), steps=steps,
                c0=float(m.state.code[s0, 0]))


def phase_depth_prior(dev):
    """Phase 9b: the depth prior on the card, held to the JAX package's CPU
    run of the same inputs: mapped to the end (the JAX test's checks and
    the code), and the fall of the first GN iteration."""
    full = depth_prior_run(dev)
    assert abs(full["c0"] - DPRIOR_CODE_JAX) < DPRIOR_CODE_TOL, full
    assert full["after"] < 0.05 and full["before"] == 0.5, full
    one = depth_prior_run(dev, pho_iters=(0, 0), max_steps=1)
    factor = one["before"] / one["after"]
    assert abs(factor / DPRIOR_FACTOR_JAX - 1.0) < DPRIOR_FACTOR_TOL, factor
    log(f"depth prior at {H}x{W}: mean |depth - 2.5| {full['before']} -> "
        f"{full['after']:.3e} in {full['steps']} mapping steps, code "
        f"{full['c0']:.7f} (JAX {DPRIOR_CODE_JAX}); after one GN iteration "
        f"{one['after']:.5f}, a fall by {factor:.4f} (JAX "
        f"{DPRIOR_FACTOR_JAX}, within {DPRIOR_FACTOR_TOL:.0%})")


# ----------------------------------------------------------------------------
# phase 10: the demo entry
# ----------------------------------------------------------------------------

def _demo_data():
    sys.path.insert(0, os.path.join(HERE, "port_tools"))
    import demo_data
    return demo_data


def demo_run(dev, tag, argv, ransac_draw=None, after_frame=None):
    """``demo.run`` on ``dev`` with DEMO_FLAGS and ``argv``, into
    build/phase10/<tag>. Sets the launch counts to 0 just before the first
    frame. ``ransac_draw``: the mapper's RANSAC draw hook (default: its
    own); ``after_frame(df, n)`` is called after the n-th processed frame.
    Returns the system, the demo's summary (with ``events``: per processed
    frame its timestamp, its event kind and whether it was lost), the
    launch counts and the host ms of each processed frame by event kind
    (each between two synchronises)."""
    import shutil

    import torch
    from deepfactors_tpu_torch import demo

    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    ms_by = {"tracking-only frames": [], "one-way-frame events": [],
             "keyframe events": []}
    events = []

    def instrument(df):
        process = df.process_frame
        if ransac_draw is not None:
            df.mapper.ransac_draw = ransac_draw

        def timed(ts, img):
            m = df.mapper
            n_kf, n_fr = m._next_kid, int(m.frames.next_id)
            sync()
            t = time.perf_counter()
            process(ts, img)
            sync()
            kind = ("keyframe events" if m._next_kid > n_kf else
                    "one-way-frame events" if int(m.frames.next_id) > n_fr
                    else "tracking-only frames")
            ms_by[kind].append((time.perf_counter() - t) * 1e3)
            events.append((float(ts), kind, bool(df.tracking_lost)))
            if after_frame is not None:
                after_frame(df, len(events))

        df.process_frame = timed
        sync()
        reset_launch_counts()

    log_dir = os.path.join(DEMO_DIR, tag)
    shutil.rmtree(log_dir, ignore_errors=True)
    df, summary = demo.run([*DEMO_FLAGS, "--device", dev, "--log_dir",
                            log_dir, *argv], on_system=instrument,
                           log=lambda m: log(f"{tag}: {m}"))
    launches = launch_counts()
    summary["events"] = events
    path = ("se3_gram_batch", "sfm_gram_batch", "sfm_error_batch")
    if dev != "cpu":
        assert all(launches[k] > 0 for k in path), \
            f"{tag}: kernel not launched: {launches}"
    ate = summary["ate"]
    log(f"{tag}: {summary['frames']} frames in {summary['seconds']:.2f} s, "
        f"tracked {summary['tracked']:.4f}, keyframes built "
        f"{summary['keyframes_built']} (live {summary['keyframes']}), ATE "
        + (f"{ate:.4f} m" if ate is not None else "none (no ground truth)")
        + f"; kernels 1-3 launches { {k: launches[k] for k in path} }; "
        f"files {summary['files']}")
    for kind, v in ms_by.items():
        log(f"{tag} {kind}: {stat(v)}")
    return df, summary, launches, ms_by


def check_results(tag, df, summary):
    """The run directory holds what save_results writes: a trajectory row
    per tracked frame, one image/depth PNG pair per live keyframe, every
    keyframe built in keyframes.txt, intrinsics.txt and flags.txt."""
    from deepfactors_tpu_torch.io import image_io

    d = summary["log_dir"]
    files = set(os.listdir(d))
    assert {"trajectory.txt", "keyframes.txt", "intrinsics.txt",
            "flags.txt"} <= files, files
    traj = np.loadtxt(os.path.join(d, "trajectory.txt"), ndmin=2)
    assert len(traj) == len(df.trajectory) == \
        summary["frames"] - df.n_lost_frames, (len(traj), summary)
    ids = df.mapper.state.ids.cpu().numpy()
    pngs = {f for f in files if f.startswith("kf_")}
    want = {f"kf_{int(ids[s])}_{k}.png" for s in df.mapper.kf_slots
            for k in ("img", "dpt")}
    assert pngs == want, (pngs, want)
    kfs = np.loadtxt(os.path.join(d, "keyframes.txt"), ndmin=2)
    assert len(kfs) == df.mapper._next_kid, (len(kfs), df.mapper._next_kid)
    img = image_io.imread(os.path.join(d, sorted(want)[-1]), "any_depth")
    assert img.shape == (H, W), img.shape
    log(f"{tag}: results {sorted(files)}")


def rep_factors(df):
    """The live rep factors as [src, dst, surviving matches], sorted."""
    pool = df.mapper.rep_pool
    return sorted([int(pool.src[i]), int(pool.dst[i]),
                   int(np.asarray(pool.mvalid[i]).sum())]
                  for i in np.nonzero(pool.active)[0])


def phase_demo_tum(dev):
    """10a: tum://DIR at 640x480 through the remap, with the port's own
    RANSAC draws, then with JAX's."""
    import shutil

    dd = _demo_data()
    import threefry_chain
    d = os.path.join(DEMO_DIR, "data_tum")
    shutil.rmtree(d, ignore_errors=True)
    t = time.perf_counter()
    sha = dd.write_tum(d, DEMO_TUM_FRAMES)
    log(f"10a: wrote {DEMO_TUM_FRAMES} frames of TUM's layout in "
        f"{time.perf_counter() - t:.1f} s, sha256 {sha} (JAX's run read "
        + ("the same)" if sha == DEMO_TUM_JAX["sha256"] else
           f"{DEMO_TUM_JAX['sha256']})"))
    df, s, launches, ms_by = demo_run(
        dev, "10a", ["--source", f"tum://{d}", "--frame_limit",
                     str(DEMO_TUM_LIMIT)])
    assert df._remap is not None, "10a: the source was not remapped"
    assert s["frames"] == DEMO_TUM_LIMIT and s["tracked"] == 1.0, s
    assert s["ate"] < DEMO_TUM_ATE_BOUND_M, \
        f"10a: ATE {s['ate']} >= {DEMO_TUM_ATE_BOUND_M}"
    lo, hi = DEMO_TUM_KEYFRAMES
    assert lo <= s["keyframes_built"] <= hi, s
    check_results("10a", df, s)
    log(f"10a: JAX's demo {DEMO_TUM_JAX}; bound {DEMO_TUM_ATE_BOUND_M} m")

    # JAX's draws: JAX's keyframes after frame 11, then the parting
    snap = os.path.join(DEMO_DIR, "10a_jax_draws_at_limit_"
                        f"{DEMO_TUM_PARITY_LIMIT}")

    def at(df, n):
        if n == DEMO_TUM_PARITY_LIMIT:
            df.save_results(snap)

    shutil.rmtree(snap, ignore_errors=True)
    chain = threefry_chain.KeyChain()
    df, s, _, _ = demo_run(
        dev, "10a_jax_draws", ["--source", f"tum://{d}", "--frame_limit",
                               str(DEMO_TUM_LIMIT)],
        ransac_draw=chain, after_frame=at)
    kf = np.loadtxt(os.path.join(snap, "keyframes.txt"), ndmin=2)
    ref = np.asarray(DEMO_TUM_JAX_KF)
    assert kf.shape == ref.shape and np.array_equal(kf[:, 0], ref[:, 0]), kf
    d_t = float(np.abs(kf[:, 1:4] - ref[:, 1:4]).max())
    d_q = float(np.abs(kf[:, 4:8] - ref[:, 4:8]).max())
    rep = rep_factors(df)
    log(f"10a_jax_draws: {chain.calls} draws; keyframes after processed "
        f"frame {DEMO_TUM_PARITY_LIMIT} against JAX's: max |d t| {d_t:.3g} "
        f"m, |d q| {d_q:.3g} (limits {DEMO_TUM_KF_T_TOL}, "
        f"{DEMO_TUM_KF_Q_TOL}); after frame 12's event rep factors {rep}, "
        f"JAX's {DEMO_TUM_JAX_REP}; ATE {s['ate']:.4f} m (JAX "
        f"{DEMO_TUM_JAX['ate']}, bound {DEMO_TUM_JAX_DRAWS_ATE_BOUND_M})")
    assert d_t <= DEMO_TUM_KF_T_TOL and d_q <= DEMO_TUM_KF_Q_TOL, (d_t, d_q)
    assert s["frames"] == DEMO_TUM_LIMIT and s["tracked"] == 1.0, s
    assert chain.calls > 0, "10a_jax_draws: no RANSAC draw"
    assert s["ate"] < DEMO_TUM_JAX_DRAWS_ATE_BOUND_M, s["ate"]
    assert lo <= s["keyframes_built"] <= hi, s
    check_results("10a_jax_draws", df, s)
    return launches


def phase_demo_files(dev):
    """10b: files://DIR at 320x240, no ground truth."""
    from deepfactors_tpu_torch.io import drivers

    dd = _demo_data()
    d = os.path.join(DEMO_DIR, "data_files")
    import shutil
    shutil.rmtree(d, ignore_errors=True)
    sha, written = dd.write_files(d, DEMO_FILES_FRAMES)
    headers = {h: any(os.path.exists(os.path.join(p, h)) for p in
                      ("/usr/include", "/usr/local/include"))
               for h in ("png.h", "jpeglib.h")}
    log(f"10b: wrote {DEMO_FILES_FRAMES} frames, sha256 {sha}; headers "
        f"{headers}; reading through {DEMO_FILES_SCHEME}://")
    url = f"{DEMO_FILES_SCHEME}://{d}"
    frames = list(drivers.get_interface_from_url(url).frames())
    assert len(frames) == DEMO_FILES_FRAMES
    for f, u in zip(frames, written):
        assert np.array_equal(f.img, u.astype(np.float32) / 255.0), \
            "10b: a decoded frame differs from the frame written"
    import threefry_chain

    df, s, launches, _ = demo_run(
        dev, "10b", ["--source", url, "--frame_limit", str(DEMO_FILES_LIMIT)],
        ransac_draw=threefry_chain.KeyChain())
    ev = s["events"]
    lost = [ts for ts, _, gone in ev if gone]
    kfs = [ts for ts, kind, _ in ev if kind == "keyframe events"]
    log(f"10b: with JAX's draws lost at frames {lost}, keyframes built at "
        f"{kfs}, {s['keyframes_built']} in all; JAX's demo {DEMO_FILES_JAX}")
    assert s["frames"] == DEMO_FILES_LIMIT and s["ate"] is None, s
    assert len(lost) == len(DEMO_FILES_JAX["lost"]), lost
    assert all(abs(a - b) <= 1 for a, b in zip(lost, DEMO_FILES_JAX["lost"]))
    assert len(kfs) == len(DEMO_FILES_JAX["keyframe_frames"]), kfs
    assert all(abs(a - b) <= 1 for a, b in
               zip(kfs, DEMO_FILES_JAX["keyframe_frames"])), kfs
    assert s["keyframes_built"] == DEMO_FILES_JAX["keyframes_built"], s
    check_results("10b", df, s)
    return launches


def phase_demo_synthetic(dev):
    """10c: synthetic://320x240:30 rendered on the card."""
    from deepfactors_tpu_torch.io import drivers

    a = list(drivers.get_interface_from_url(DEMO_SYN, device=dev).frames())
    b = list(drivers.get_interface_from_url(DEMO_SYN, device="cpu").frames())
    diffs = [np.abs(x.img - y.img) for x, y in zip(a, b)]
    err = max(float(d.max()) for d in diffs)
    perr = max(float((u - v).abs().max()) for x, y in zip(a, b)
               for u, v in zip(x.gt_pose, y.gt_pose))
    log(f"10c: synthetic frames card vs CPU: max |d img| {err:.3g} "
        f"(pixels over 1e-5: {sum(int((d > 1e-5).sum()) for d in diffs)} of "
        f"{sum(d.size for d in diffs)}), max |d pose| {perr:.3g}")
    assert len(a) == len(b) == 30 and err <= DEMO_RENDER_TOL, err
    assert perr <= 1e-6, perr
    df, s, launches, _ = demo_run(dev, "10c", ["--source", DEMO_SYN])
    assert s["frames"] == 28 and s["tracked"] == 1.0, s
    assert s["ate"] < DEMO_SYN_ATE_BOUND_M, \
        f"10c: ATE {s['ate']} >= {DEMO_SYN_ATE_BOUND_M}"
    assert abs(s["keyframes_built"] - DEMO_SYN_JAX["keyframes_built"]) <= 1, s
    check_results("10c", df, s)
    log(f"10c: JAX's demo {DEMO_SYN_JAX}; bound {DEMO_SYN_ATE_BOUND_M} m")
    return launches


class ScheduleTee:
    """The native scheduler backend with a Python scheduler beside it: each
    call goes to both, the mapper sees the native backend's pools and work
    ids, and after each bookkeeping both photometric pools' (active, level
    where active) and their budgets are compared; ``steps`` counts the
    comparisons."""

    def __init__(self, nat, py):
        self.nat, self.py = nat, py
        self.steps = 0
        self._works = {}

    def __getattr__(self, name):   # pools and repgeo_version
        return getattr(self.nat, name)

    def add_photo(self, *a, **kw):
        wid = self.nat.add_photo(*a, **kw)
        self._works[wid] = self.py.add_photo(*a, **kw)
        return wid

    def add_rep(self, *a, **kw):
        self.py.add_rep(*a, **kw)
        return self.nat.add_rep(*a, **kw)

    def add_geo(self, src, dst, iters, points, parent=None):
        self.py.add_geo(src, dst, iters, points,
                        parent=self._works.get(parent))
        return self.nat.add_geo(src, dst, iters, points, parent=parent)

    def erase_frame(self, fslot):
        self.nat.erase_frame(fslot)
        self.py.erase_frame(fslot)

    def erase_keyframe(self, slot):
        self.nat.erase_keyframe(slot)
        self.py.erase_keyframe(slot)

    def bookkeeping(self, stochastic_geo_resample=None):
        self.nat.bookkeeping()
        self.py.bookkeeping()
        a, b = self.nat.photo_pool, self.py.photo_pool
        step = self.steps
        assert np.array_equal(a.active, b.active), \
            f"step {step}: active native {a.active} python {b.active}"
        assert np.array_equal(a.level[a.active], b.level[b.active]), \
            f"step {step}: levels native {a.level} python {b.level}"
        for p, q in ((self.nat.rep_pool, self.py.rep_pool),
                     (self.nat.geo_pool, self.py.geo_pool)):
            assert np.array_equal(p.active, q.active), f"step {step}"
        self.steps += 1

    def budget(self):
        n, p = self.nat.budget(), self.py.budget()
        assert n == p, f"step {self.steps}: budget {n} != {p}"
        return n

    def update(self, iters_done, converged):
        self.nat.update(iters_done, converged)
        self.py.update(iters_done, converged)

    def has_work(self):
        n = self.nat.has_work()
        assert n == self.py.has_work(), f"step {self.steps}: has_work"
        return n

    def fused_sig(self):
        n, p = self.nat.fused_sig(), self.py.fused_sig()
        assert n == p, f"step {self.steps}: fused_sig {n} != {p}"
        return n

    def descent_slots(self):
        n = self.nat.descent_slots()
        assert np.array_equal(n, self.py.descent_slots())
        return n

    def tick_empty(self):
        self.nat.tick_empty()
        self.py.tick_empty()


def phase_native_scheduler(dev, decoder):
    """10d: phase 4's configuration on the native scheduler, shadowed by the
    Python one; then the Python scheduler alone, in the same call."""
    from deepfactors_tpu_torch.mapping import mapper as mapper_mod
    from deepfactors_tpu_torch.mapping.scheduler import NativeBackend, \
        PyScheduler

    tee = []    # the mapper makes its scheduler anew at each reset

    def make_teed(cfg):
        assert cfg.use_native_scheduler
        tee.append(ScheduleTee(NativeBackend(cfg), PyScheduler(cfg)))
        return tee[-1]

    make = mapper_mod.make_scheduler
    mapper_mod.make_scheduler = make_teed
    try:
        nat = run_facade(dev, decoder, "10d native", scene_seed=7,
                         n_frames=N_FRAMES, max_keyframes=32,
                         max_factors=128, use_reprojection=True,
                         time_parts=False, native_scheduler=True)
    finally:
        mapper_mod.make_scheduler = make
    launches = launch_counts()
    assert nat["df"].mapper.sched is tee[-1]
    py = run_facade(dev, decoder, "10d python", scene_seed=7,
                    n_frames=N_FRAMES, max_keyframes=32, max_factors=128,
                    use_reprojection=True, time_parts=False)
    a, b = nat["df"], py["df"]
    counts = [(r["df"].mapper._next_kid,
               int(r["df"].mapper.rep_pool.active.sum()), r["ate"])
              for r in (nat, py)]
    log(f"10d: native schedule equal to the Python scheduler's at all "
        f"{tee[-1].steps} bookkeepings; (keyframes built, rep factors live, "
        f"ATE) native {counts[0]}, python {counts[1]}; tolerance "
        f"{NATIVE_ATE_TOL_M} m")
    assert tee[-1].steps > 0
    assert a.n_lost_frames == b.n_lost_frames == 0
    assert counts[0][:2] == counts[1][:2], counts
    assert abs(counts[0][2] - counts[1][2]) <= NATIVE_ATE_TOL_M, counts
    return launches, py


def phase_resume(dev, decoder, py):
    """10e: checkpoint after a keyframe event, restore into a fresh system,
    go on; the rest against 10d's uninterrupted Python run."""
    import tempfile

    from deepfactors_tpu_torch.system import DeepFactors
    from deepfactors_tpu_torch.utils import checkpoint as ckpt
    import torch

    r = run_facade(dev, decoder, "10e first part", scene_seed=7,
                   n_frames=N_FRAMES, max_keyframes=32, max_factors=128,
                   use_reprojection=True, time_parts=False,
                   schedule=list(range(3, RESUME_FROM)))
    df, frames = r["df"], r["frames"]
    cut = RESUME_FROM
    while True:
        n_kf = df.mapper._next_kid
        df.process_frame(float(cut), frames[cut])
        cut += 1
        if df.mapper._next_kid > n_kf or cut >= N_FRAMES - 5:
            break
    assert df.mapper._next_kid > n_kf, "10e: no keyframe event to cut at"
    with tempfile.TemporaryDirectory(dir=DEMO_DIR) as d:
        t = time.perf_counter()
        ckpt.save_checkpoint(d, df)
        save_s = time.perf_counter() - t
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        fresh = DeepFactors(df.cfg, df.cam, decoder=decoder, device=dev)
        t = time.perf_counter()
        ckpt.load_checkpoint(d, fresh)
        load_s = time.perf_counter() - t
    reset_launch_counts()
    for i in range(cut, N_FRAMES):
        fresh.process_frame(float(i), frames[i])
    if dev != "cpu":
        torch.cuda.synchronize()
    launches = launch_counts()
    ref = {ts: p for ts, p in py["df"].trajectory}
    rest = [(ts, p) for ts, p in fresh.trajectory if ts >= cut]
    assert len(rest) == N_FRAMES - cut and fresh.n_lost_frames == 0
    d_t = max(float(np.linalg.norm(np.asarray(p.t) - np.asarray(ref[ts].t)))
              for ts, p in rest)
    kfs = (fresh.mapper._next_kid, py["df"].mapper._next_kid)
    log(f"10e: checkpoint after frame {cut - 1} (a keyframe event): "
        f"{size} bytes, save {save_s:.2f} s, load {load_s:.2f} s; frames "
        f"{cut}-{N_FRAMES - 1} resumed: max |d t| to the uninterrupted "
        f"run {d_t:.3g} m (tolerance {RESUME_TOL_M}), keyframes built "
        f"{kfs}; kernel launches {launches}")
    assert d_t <= RESUME_TOL_M, d_t
    assert kfs[0] == kfs[1], kfs
    return launches


def phase_demo(dev, decoder):
    """Phase 10: 10a-10e. Returns the launch counts of each path."""
    os.makedirs(DEMO_DIR, exist_ok=True)
    out = {"demo_tum": phase_demo_tum(dev),
           "demo_files": phase_demo_files(dev),
           "demo_synthetic": phase_demo_synthetic(dev)}
    out["native_scheduler"], py = phase_native_scheduler(dev, decoder)
    out["resume"] = phase_resume(dev, decoder, py)
    return out


# ----------------------------------------------------------------------------
# phase 11: decoder training
# ----------------------------------------------------------------------------

def train_step_inputs():
    """11a's parameter tree (room256_32v4's decoder, ``encoder_tree()``),
    batch (the port's plain render of TRAIN_ROOMS, on the CPU so that the
    card and the CPU step on the same bits) and JAX's eps (threefry)."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "port_tools"))
    import threefry_chain
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.models.decoder import load_params

    dec = load_params(os.path.join(HERE, "data", "nets", "room256_32v4.pkl"))
    tree = {"params": {"decoder": dec["params"], "encoder": encoder_tree()}}
    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    q, t = train_batch_poses()
    imgs, dpts = zip(*[synth.render(synth.random_room(r, 3), cam,
                                    SE3(q[i], t[i]), H, W, device="cpu")
                       for i, r in enumerate(TRAIN_ROOMS)])
    imgs, dpts = torch.stack(imgs), torch.stack(dpts)
    keys = threefry_chain.split(threefry_chain.prng_key(TRAIN_EPS_SEED),
                                len(TRAIN_ROOMS))
    eps = torch.from_numpy(np.stack([threefry_chain.normal(k, (32,))
                                     for k in keys]))
    return tree, imgs, 2.0 / (2.0 + dpts), eps


def train_step_run(dev, tree, imgs, gts, eps, time_it=False, group=None):
    """One recipe step on ``dev`` from ``tree``; returns the loss and its
    terms, the gradients and the parameters after the update (on the CPU),
    and the device ms of a step when ``time_it``. With ``group`` (13e) this
    rank steps on its rows of the batch (eps stays the whole batch's)."""
    import torch
    from deepfactors_tpu_torch import configure_numerics
    from deepfactors_tpu_torch.models import train_decoder as td
    from deepfactors_tpu_torch.parallel import multihost

    configure_numerics()
    hp = TRAIN_HP
    m = td.VAEModel(32, 3, 32, "conv", (H, W))
    m.load_state_dict(td.vae_params_from_jax(tree))
    m.to(dev).train()
    opt = td.OptaxAdam(m.parameters(), td.cosine_decay_schedule(
        hp["lr"], hp["decay_steps"], hp["alpha"]),
        weight_decay=hp["weight_decay"], clip_norm=hp["clip"])
    step = td.make_train_step(m, opt, hp["beta"], hp["distill_w"], group)
    rows = multihost.rank_rows(imgs.shape[0], *multihost.world_rank(group))
    args = [x.to(dev) for x in (imgs[rows], gts[rows], eps)]
    loss, aux = step(*args)
    out = {k: float(v) for k, v in aux.items()}
    out["loss"] = float(loss)
    out["grads"] = {n: p.grad.detach().cpu().clone()
                    for n, p in m.named_parameters()}
    out["params"] = {n: p.detach().cpu().clone()
                     for n, p in m.named_parameters()}
    if time_it:
        out["ms"] = cuda_ms(lambda: step(*args), iters=10)
    return out


def phase_train_step(dev):
    """11a: one step at full width, card against the port on the CPU;
    11b: the same step against JAX's CPU run (TRAIN_JAX)."""
    import torch
    tree, imgs, gts, eps = train_step_inputs()
    card = train_step_run(dev, tree, imgs, gts, eps, time_it=True)
    cpu = train_step_run("cpu", tree, imgs, gts, eps)
    for k in ("loss", "nll"):
        assert abs(card[k] - cpu[k]) <= TRAIN_LOSS_TOL * abs(cpu[k]), k
    for k in ("kl", "distill", "grad_norm"):
        assert abs(card[k] - cpu[k]) <= TRAIN_TERM_TOL * abs(cpu[k]), k
    worst, num, den = {}, 0.0, 0.0
    for n, g in cpu["grads"].items():
        a = card["grads"][n]
        assert bool(torch.isfinite(a).all()), n
        e, d = float((a - g).norm()), float(g.norm())
        worst[n] = e / d
        num, den = num + e * e, den + d * d
        assert e <= TRAIN_LEAF_TOL * d, (n, e / d)
    assert (num / den) ** 0.5 <= TRAIN_ALL_TOL, (num / den) ** 0.5
    # Adam's first step moves each element by ~lr x sign(g): where a
    # gradient element is near 0 the two signs may differ, never more
    lr0 = TRAIN_HP["lr"]
    moved = far = total = 0
    for n, p in cpu["params"].items():
        d = (card["params"][n] - p).abs()
        assert float(d.max()) <= 2.0 * lr0 * 1.001 + 1e-6, n
        far += int((d > 0.1 * lr0).sum())
        total += d.numel()
    assert far <= TRAIN_FLIP_SHARE * total, far / total
    n_worst = max(worst, key=worst.get)
    log(f"11a one recipe step at 192x256, batch 8 (VAEModel CS 32, 3 levels, "
        f"conv head; room256_32v4's decoder): loss {card['loss']:.6f} (CPU "
        f"{cpu['loss']:.6f}), nll {card['nll']:.6f} ({cpu['nll']:.6f}), kl "
        f"{card['kl']:.6f} ({cpu['kl']:.6f}), distill {card['distill']:.6f} "
        f"({cpu['distill']:.6f}), grad norm {card['grad_norm']:.6f} "
        f"({cpu['grad_norm']:.6f}); gradients over all leaves rel "
        f"{(num / den) ** 0.5:.2e}, worst leaf {n_worst} {worst[n_worst]:.2e}"
        f"; parameters after the update: {far} of {total} elements apart by "
        f"more than 0.1 lr; card step {card['ms']:.3f} ms; {smi_line()}")
    # 11b: against JAX
    j = TRAIN_JAX
    for k in ("loss", "nll"):
        assert abs(card[k] - j[k]) <= TRAIN_LOSS_TOL * abs(j[k]), k
    for k in ("kl", "distill"):
        assert abs(card[k] - j[k]) <= TRAIN_TERM_TOL * abs(j[k]), k
    groups = grad_groups(card["grads"])
    gsum = lambda ns: sum(float(card["grads"][n].double().square().sum())
                          for n in ns)
    kn = sum(gsum(v) for v in groups.values()) ** 0.5
    assert abs(kn - j["grad_norm_kernels"]) <= TRAIN_TERM_TOL * kn
    group_err = {k: abs(gsum(v) ** 0.5 - j["kernel_grad_norms"][k])
                 / j["kernel_grad_norms"][k] for k, v in groups.items()}
    assert set(group_err) == set(j["kernel_grad_norms"])
    assert max(group_err.values()) <= TRAIN_LEAF_TOL, group_err
    hb = card["grads"]["decoder.Conv_7.bias"].double().numpy()
    want = np.asarray(j["finest_head_bias_grad"])
    hb_err = float(np.linalg.norm(hb - want) / np.linalg.norm(want))
    assert hb_err <= TRAIN_LEAF_TOL, hb_err
    g_worst = max(group_err, key=group_err.get)
    log(f"11b the same step against JAX's make_train_step on a CPU "
        f"(port_tools/jax_train_reference.py): loss {j['loss']:.6f}, nll "
        f"{j['nll']:.6f}, kl {j['kl']:.6f}, distill {j['distill']:.6f}; "
        f"kernel-gradient norm {kn:.6f} (JAX {j['grad_norm_kernels']:.6f}), "
        f"worst module {g_worst} {group_err[g_worst]:.2e}; finest head's bias "
        f"against JAX's forward mode {hb_err:.2e}")
    return card


def phase_train_recipe(dev):
    """11c: train_room_decoder.main on the card, 300 steps; the weights it
    writes read back and linear. Returns the loaded decoder."""
    import torch
    from deepfactors_tpu_torch import train_room_decoder as trd
    from deepfactors_tpu_torch.models.decoder import load_decoder, load_params

    out = os.path.join(TRAIN_DIR, "room256_p11")
    t0 = time.time()
    r = trd.main(TRAIN_RECIPE_ARGV + ["--out", out, "--device", dev], log=log)
    wall = time.time() - t0
    nll = r["nll"]
    assert np.isfinite(nll).all() and len(nll) == TRAIN_RECIPE_STEPS
    first, last = float(nll[:50].mean()), float(nll[-50:].mean())
    assert last < first, (first, last)
    warm = r["step_ms"][TRAIN_WARM_STEPS:]
    dec = load_decoder(out, device=dev)
    params = load_params(out + ".pkl")
    assert dec.cfg.pred_head == "conv" and dec.cfg.code_size == 32
    img = torch.rand(H, W, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    res0 = dec.decode(img, torch.zeros(32, device=dev))
    c = torch.full((32,), 0.3, device=dev)
    res = dec.decode(img, c)
    for lvl in range(3):
        pred = res0.prx[lvl] + res0.jac[lvl] @ c
        assert float((res.prx[lvl] - pred).abs().max()) <= 1e-5, lvl
    v = r["val"]
    log(f"11c train_room_decoder on the card ({' '.join(TRAIN_RECIPE_ARGV)}): "
        f"{r['frames']} frames rendered in {r['dataset_s']:.2f} s; "
        f"{TRAIN_RECIPE_STEPS} steps in {r['train_s']:.2f} s; ms per step "
        f"(CUDA events between steps on the card) median {np.median(warm):.3f}, p90 "
        f"{np.percentile(warm, 90):.3f} over steps {TRAIN_WARM_STEPS}+; "
        f"peak device memory {(r['peak_bytes'] or 0) / 2**20:.1f} MiB; nll mean of "
        f"steps 0-49 {first:.4f}, 250-299 {last:.4f}; loss at steps "
        f"{[(i, round(x, 4)) for i, x in r['logged']]}; held-out depth "
        f"RMSE zero-code {v[0]:.4f} m, pred-code {v[1]:.4f}, opt-code "
        f"{v[5]:.4f}; prox RMSE zero {v[2]:.4f}, pred {v[3]:.4f}; "
        f"{len(params['params'])} modules written to {out}.pkl, read back "
        f"linear within 1e-5; {wall:.1f} s in all; {smi_line()}")
    return dec


def phase_train(dev):
    """Phase 11: 11a-11d. Returns 11d's launch counts."""
    os.makedirs(TRAIN_DIR, exist_ok=True)
    phase_train_step(dev)
    dec = phase_train_recipe(dev)
    r = run_facade(dev, dec, "11d", scene_seed=7, n_frames=TRAIN_SERVE_FRAMES,
                   max_keyframes=32, max_factors=128, use_reprojection=True,
                   time_parts=False)
    launches = launch_counts()
    df = r["df"]
    assert df.n_lost_frames == 0 and r["tracked"] == 1.0, "frames lost"
    assert all(launches[k] > 0 for k in ("se3_gram_batch", "sfm_gram_batch")
               ), launches
    log(f"11d phase 4's configuration on {TRAIN_SERVE_FRAMES} frames with "
        f"11c's decoder: tracked {r['tracked']}, {df.mapper._next_kid} "
        f"keyframes, ATE {r['ate']:.4f} m (not bounded: 300 steps); "
        f"launches {launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 12: the tools
# ----------------------------------------------------------------------------

def _rel_err(a, b):
    import torch
    a, b = torch.as_tensor(a).cpu().double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def phase_tools(dev, decoder=None):
    """Phase 12: every tool of deepfactors_tpu_torch/tools on the card, at
    192x256 with room256_32v4 and CS 32, through each tool's ``main`` (its
    command line) or, for the live viewer, its class: the files each writes,
    and the numbers it computes against the same tool on the CPU. The
    launch counts are set to 0 when 12a's facade starts and read at the
    end. Returns them."""
    import shutil

    import torch
    from deepfactors_tpu_torch.tools import (decode_image, kernel_benchmark,
                                             live_viewer, profile_ba,
                                             profile_dispatch, profile_event,
                                             replay_viewer, result_viewer,
                                             schur_crossover, test_matching,
                                             voc_builder, voc_test)
    from deepfactors_tpu_torch.tools.bench_config import load_bench_decoder

    t_phase = time.perf_counter()
    before = set(sys.modules)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    d = lambda *p: os.path.join(TOOLS_DIR, *p)  # noqa: E731
    say = lambda m: log(f"12 {m}")  # noqa: E731
    decoder = decoder if decoder is not None else load_bench_decoder(dev)

    # 12a: LiveViewer on phase 4's configuration, then the run directory
    viewers = []
    r = run_facade(dev, decoder, "12a", scene_seed=7,
                   n_frames=TOOLS_LIVE_FRAMES, max_keyframes=32,
                   max_factors=128, use_reprojection=True, time_parts=False,
                   setup=lambda df: viewers.append(
                       live_viewer.LiveViewer(d("live"), df)))
    df, lv = r["df"], viewers[0]
    assert r["tracked"] == 1.0, "12a lost frames"
    with open(d("live", "viewer.html")) as f:
        assert "http-equiv=\"refresh\"" in f.read(), "no live refresh tag"
    lv.finish()
    with open(d("live", "viewer.html")) as f:
        assert "http-equiv=\"refresh\"" not in f.read()
    n_kf = df.mapper._next_kid
    kf_files = sorted(f for f in os.listdir(d("live")) if f.startswith("kf_"))
    assert len(kf_files) == 2 * n_kf, (kf_files, n_kf)
    with open(d("live", "trajectory.txt")) as f:
        assert len(f.read().splitlines()) == len(df.trajectory)
    df.save_results(d("run"))
    assert replay_viewer.main([d("run"), "--device", dev]) == 0
    assert os.path.getsize(d("run", "viewer.html")) > 100_000
    assert result_viewer.main([d("run"), "--out", d("viewer"),
                               "--device", dev]) == 0
    out = sorted(os.listdir(d("viewer")))
    assert sum(f.endswith("_depth_color.png") for f in out) == n_kf, out
    assert "map.ply" in out
    # trajectory.png is matplotlib's: written where it imports, else the
    # viewer says so and writes the rest
    have_mpl = any(m.split(".")[0] == "matplotlib" for m in sys.modules)
    assert ("trajectory.png" in out) == have_mpl, out
    say(f"viewers: {n_kf} keyframes of {TOOLS_LIVE_FRAMES} frames, live "
        f"page refreshed during the run, replay page "
        f"{os.path.getsize(d('run', 'viewer.html')) / 1e6:.2f} MB, result "
        f"viewer files {out}")

    # 12b: decode_image, the card against the CPU
    dec = {x: decode_image.main(["synthetic", "--ntests", "10" if x == dev
                                 else "1", "--out", d("decode", x),
                                 "--device", x], log=say)
           for x in (dev, "cpu")}
    for k in ("prx_zero", "prx_predicted", "code"):
        a, b = dec[dev][k], dec["cpu"][k]
        err = float(np.abs(a - b).max() / np.abs(b).max())
        assert np.isfinite(a).all() and err < DECODER_TOL, (k, err)
    assert sorted(os.listdir(d("decode", dev))) == [
        "depth_predicted_code.png", "depth_zero_code.png", "input.png"]

    # 12c: test_matching
    m = test_matching.main(["--source", TOOLS_MATCH_SOURCE, "--out",
                            d("matches.png"), "--device", dev], log=say)
    assert m["matches"] >= 20 and m["inliers"] >= 8, m
    assert os.path.getsize(d("matches.png")) > 0

    # 12d: voc_builder and voc_test on the card (k-means on the host); then
    # voc_test with that vocabulary on the card and on the CPU over the same
    # frames: the source's frames rendered on the CPU, as PNGs of a files://
    # source (the card's render differs from the CPU's by up to ~3e-5,
    # phase 10c, which moves keypoints and words: 1.3e-2 apart in BoW)
    from deepfactors_tpu_torch.io import drivers, image_io
    v = voc_builder.main(["--source", TOOLS_VOC_SOURCE, "--out",
                          d("voc.npz"), "--device", dev], log=say)
    with np.load(d("voc.npz")) as z:
        assert sorted(z.files) == ["idf", "words"]
        assert z["words"].dtype == np.uint32 and z["idf"].dtype == np.float32
        assert np.array_equal(z["words"], v["words"])
    voc_test.main(["--source", TOOLS_VOC_SOURCE, "--vocab", d("voc.npz"),
                   "--device", dev], log=say)
    os.makedirs(d("voc_frames"))
    for i, fd in enumerate(drivers.get_interface_from_url(
            TOOLS_VOC_SOURCE, device="cpu").frames()):
        image_io.imwrite(d("voc_frames", f"{i:03d}.png"),
                         (np.clip(fd.img, 0, 1) * 255 + 0.5).astype(np.uint8))
    vt = {x: voc_test.main(["--source", "files://" + d("voc_frames"),
                            "--vocab", d("voc.npz"), "--device", x], log=say)
          for x in (dev, "cpu")}
    bow_err = float(np.abs(vt[dev]["bow"] - vt["cpu"]["bow"]).max())
    s_err = float(np.abs(vt[dev]["S"] - vt["cpu"]["S"]).max())
    assert bow_err <= BOW_SIM_TOL and s_err <= BOW_SIM_TOL, (bow_err, s_err)

    # 12e-12h: the benchmark and the profiles
    on_card = dev != "cpu"
    kb = kernel_benchmark.main(["--device", dev], log=say)
    ba = profile_ba.main(["--device", dev], log=say)
    disp = {mode: profile_dispatch.main([mode, "--device", dev], log=say)
            for mode in ("main", "n0", "fixed")}
    ev = profile_event.main(["--device", dev], log=say)
    per_iter = [t / n * 1e3 for n, t in zip(disp["main"]["n"],
                                            disp["main"]["seconds"])]
    # the profiler traces each tool's rows (tools/common.kernel_time): a
    # row it could not trace after its retries reads None and is listed
    untraced = [k for k, t in [(f"{r['name']} B={r['batch']}", r)
                               for r in kb] + list(ba.items())
                + list(ev.items()) if not t["kernels"]]
    if on_card:
        assert all(any(t["kernels"] for t in rows) for rows in (
            kb, ba.values(), ev.values())), untraced

    # 12i: schur_crossover, the solutions against the CPU's
    sc = schur_crossover.main(["--device", dev], log=say)
    assert [r["K"] for r in sc] == list(schur_crossover.KS)
    worst = 0.0
    for K in schur_crossover.KS:
        g, gc = (schur_crossover.build_system(K, device=x)
                 for x in (dev, "cpu"))
        lam, CS = schur_crossover.LAM, schur_crossover.CS
        sysm = schur_crossover.sysm
        for solve in (lambda s: sysm.solve_damped(s, lam),
                      lambda s: sysm.solve_schur_codes(s, K, CS, lam)):
            worst = max(worst, _rel_err(solve(g), solve(gc)))
    assert worst < TOOLS_SOLVE_TOL, worst

    launches = launch_counts()
    assert all(n > 0 for n in launches.values()) or not on_card, launches
    new = {m.split(".")[0] for m in set(sys.modules) - before}
    assert "cv2" not in new, "a tool imported cv2"
    say(f"card vs CPU: decode prx within {DECODER_TOL}; BoW vectors "
        f"{bow_err:.2e}, scores {s_err:.2e}; solves {worst:.2e} (K = "
        f"{schur_crossover.KS[0]}..{schur_crossover.KS[-1]}); a mapper run "
        f"with no iteration {np.median(disp['n0'][0]):.2f} ms,"
        f" a GN iteration {np.median(per_iter):.1f} ms on the host against "
        f"{disp['main']['kernel_us']} us of kernels; rows the profiler did "
        f"not trace {untraced}; launches "
        f"{launches}; cv2 not imported, matplotlib "
        f"{'imported' if have_mpl else 'not importable'}; phase 12 "
        f"{time.perf_counter() - t_phase:.1f} s; "
        f"{smi_line() if on_card else 'cpu'}")
    return launches



# ----------------------------------------------------------------------------
# phase 13: several ranks
# ----------------------------------------------------------------------------

def multi_backend(n, dev):
    """The backend of a world of ``n`` ranks: NCCL with a card a rank,
    else gloo (on one card every rank sits on cuda:0: NCCL refuses two
    ranks on one device). Chosen here and passed on; nothing falls back."""
    import torch
    if dev == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= n else "gloo"


def _cards(dev):
    import torch
    return torch.cuda.device_count() if dev != "cpu" else 0


def _digest_values(line):
    return [float(x) for x in line.split()[1:]]


def _digest_close(a, b):
    """sum |t| within MULTI_DEMO_TOL, the inlier count within
    MULTI_DEMO_TOL of itself."""
    return (abs(a[0] - b[0]) <= MULTI_DEMO_TOL
            and abs(a[1] - b[1]) <= MULTI_DEMO_TOL * abs(b[1]))


def phase_multi_demo(dev):
    """13a: tools.multihost_demo at production size over 2 ranks, against
    one process on the card and JAX's digest. Returns the ranks' launches
    summed."""
    from deepfactors_tpu_torch.tools import multihost_demo as md
    backend = multi_backend(2, dev)
    t0 = time.perf_counter()
    r = md.main(["--nproc", "2", "--backend", backend, "--device", dev,
                 "--timeout", str(MULTI_TIMEOUT_S)], log=lambda *a: None)
    wall = time.perf_counter() - t0
    assert r["ok"], "13a: the demo failed:\n" + "\n".join(r["outputs"])
    ranks = [_digest_values(d) for d in r["digests"]]
    q, t, c, stats = md.run_steps(8, 32, H, W, 8, dev)
    one = _digest_values(md.digest(t, stats))
    assert all(_digest_close(x, one) for x in ranks), (ranks, one)
    assert all(_digest_close(x, MULTI_DEMO_JAX) for x in ranks), ranks
    per_rank = [x["dense_warp_batch"] for x in r["launches"]]
    if dev != "cpu":
        assert len(r["launches"]) == 2 and per_rank == [md.STEPS] * 2, \
            r["launches"]
    red = r["reduce"]
    log(f"13a multihost_demo: backend {backend}, world 2, {_cards(dev)} "
        f"card(s); 8 factors at {H}x{W}, CS 32, {md.STEPS} steps; digests "
        f"{r['digests']} (agree), one process {md.digest(t, stats)}, JAX "
        f"{MULTI_DEMO_JAX} (within {MULTI_DEMO_TOL}); dense_warp_batch "
        f"launches per rank {per_rank}; a step's all_reduce (H, b, stats: "
        f"{red[0]['bytes']} bytes) {[round(x['ms'], 3) for x in red]} ms "
        f"per rank (host, median of 20); {wall:.1f} s with the ranks' "
        f"start; {smi_line() if dev != 'cpu' else 'cpu'}")
    return sum_counts(r["launches"])


def phase_multi_dryrun(dev):
    """13b: the dry-run matrix over MULTI_DRYRUN_WORLDS, every world within
    1e-4 of world 1, and world 1 within MULTI_SAME_TOL of 6a's
    ``dryrun_single`` in this process (whose own two runs are read beside
    it)."""
    from deepfactors_tpu_torch.parallel import dryrun
    backend = multi_backend(max(MULTI_DRYRUN_WORLDS), dev)
    t0 = time.perf_counter()
    devs, res = dryrun.dryrun_matrix(MULTI_DRYRUN_WORLDS, tol=1e-4,
                                     backend=backend, device=dev,
                                     timeout_s=MULTI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    single = [dict(zip("qtc", dryrun.dryrun_single(dev))) for _ in range(2)]
    first = res[MULTI_DRYRUN_WORLDS[0]]
    d1 = max(float(np.abs(first[k] - single[0][k]).max()) for k in "qtc")
    again = max(float(np.abs(single[1][k] - single[0][k]).max())
                for k in "qtc")
    assert d1 <= MULTI_SAME_TOL, f"world 1 parts from dryrun_single by {d1}"
    launches = {n: r["launches"] for n, r in res.items()}
    dwb = {n: [x["dense_warp_batch"] for x in c] for n, c in launches.items()}
    if dev != "cpu":
        assert all(x == [1] * n for n, x in dwb.items()), launches
    log(f"13b dry-run matrix: backend {backend}, worlds "
        f"{list(MULTI_DRYRUN_WORLDS)}, {_cards(dev)} card(s): deviation "
        f"from world 1 {devs} (tol 1e-4); world 1 against dryrun_single "
        f"{d1:.3e} (tol {MULTI_SAME_TOL}), dryrun_single against itself "
        f"{again:.3e}; dense_warp_batch launches per rank {dwb}; "
        f"{wall:.1f} s with the ranks' start")
    return sum_counts(x for c in launches.values() for x in c)


def phase_multi_nccl(dev):
    """13c: an NCCL group created and used on this card: a world of one
    all_reduces the dry-run system (H, b, stats), which must come back bit
    for bit."""
    import tempfile
    import torch
    import torch.distributed as dist
    from deepfactors_tpu_torch.parallel import dist_ba, dryrun, multihost
    cards = _cards(dev)
    with tempfile.TemporaryDirectory(prefix="df_nccl_") as tmp:
        multihost.initialize("file://" + os.path.join(tmp, "rendezvous"),
                             1, 0, backend="nccl", device=dev)
        try:
            backend = dist.get_backend()
            cam, params, fd, q, t, c, _ = dryrun.dryrun_problem(
                multihost.local_device())
            reset_launch_counts()
            system = dist_ba.local_system(q, t, c, fd, dryrun.K, dryrun.CS,
                                          cam, params)
            launches = launch_counts()
            before = [x.clone() for x in system]
            for x in system:
                dist.all_reduce(x, group=multihost.global_group())
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(system, before))
        finally:
            multihost.shutdown()
    assert backend == "nccl" and same, (backend, same)
    assert launches["dense_warp_batch"] == 1, launches
    across = ("NCCL across cards: not run (1 card)" if cards < 2 else
              f"NCCL across cards: 13a (world 2) and 13b (worlds "
              f"{[n for n in MULTI_DRYRUN_WORLDS if n <= cards]}) ran on "
              f"NCCL over {cards} cards")
    log(f"13c NCCL: backend {backend}, world 1, {cards} card(s): the "
        f"dry-run system (H {tuple(system[0].shape)}, b, stats) "
        f"all_reduced bit for bit; {across}; launches {launches}")
    return launches


def multi_rank_data(dev):
    """13d and 13e's inputs, written once for the ranks: 6c's frames and
    depths (rendered here), 11a's parameter tree, batch and eps."""
    import torch
    setup = odometry_setup(dev)
    tree, imgs, gts, eps = train_step_inputs()
    data = {"frames": setup["frames"].cpu(), "depth0": setup["depth0"].cpu(),
            "true_t": setup["true_t"].cpu(), "tree": tree, "imgs": imgs,
            "gts": gts, "eps": eps}
    os.makedirs(MULTI_DIR, exist_ok=True)
    path = os.path.join(MULTI_DIR, "rank_data.pt")
    torch.save(data, path)
    return setup, data, path


def rank_task(args):
    """A rank of phase 13's world of 13d and 13e (started by
    ``multihost.World`` as ``chip_smoke.py --rank-task ...``): 6c's
    odometry over the world, 11a's step on this rank's rows, then
    MULTI_RECIPE_STEPS of 11c's recipe through ``train_room_decoder
    --distributed``; writes what it read to ``--rank-out``.rank<r>.pt,
    with the rank's kernel launches from the odometry's start (where
    ``odometry_run`` sets the counts to 0) to the recipe's end."""
    import torch
    from deepfactors_tpu_torch import train_room_decoder as trd
    from deepfactors_tpu_torch.parallel import multihost
    multihost.initialize(args.coord, args.nproc, args.proc_id,
                         backend=args.backend, device=args.rank_device)
    try:
        dev = multihost.local_device()
        group = multihost.global_group()
        data = torch.load(args.rank_data, weights_only=False)
        setup = dict(cam=_smoke_camera(), frames=data["frames"].to(dev),
                     depth0=data["depth0"].to(dev),
                     true_t=data["true_t"].to(dev))
        odo_launches, poses = odometry_run(setup, group)
        step = train_step_run(dev, data["tree"], data["imgs"], data["gts"],
                              data["eps"], group=group)
        out = os.path.join(MULTI_DIR, "room256_p13")
        recipe = trd.main(MULTI_RECIPE_ARGV + ["--distributed", "--device",
                                               args.rank_device, "--out",
                                               out], log=log)
        launches = launch_counts()
        torch.save({"odo_launches": odo_launches, "launches": launches,
                    "poses": poses, "step": step, "nll": recipe["nll"],
                    "step_ms": recipe["step_ms"], "world": recipe["world"],
                    "device": str(dev)},
                   f"{args.rank_out}.rank{args.proc_id}.pt")
    finally:
        multihost.shutdown()
    return 0


def _train_spread(a, b):
    """World n against one process: the terms (relative), every leaf's
    gradient and all together (relative L2), the parameters after the
    update (the largest difference over lr, the share of elements apart by
    more than 0.1 lr)."""
    terms = {k: abs(a[k] - b[k]) / abs(b[k])
             for k in ("loss", "nll", "kl", "distill", "grad_norm")}
    leaf = {n: float((a["grads"][n] - g).norm() / g.norm())
            for n, g in b["grads"].items()}
    num = sum(float((a["grads"][n] - g).norm()) ** 2
              for n, g in b["grads"].items())
    den = sum(float(g.norm()) ** 2 for g in b["grads"].values())
    lr = TRAIN_HP["lr"]
    diffs = [(a["params"][n] - p).abs() for n, p in b["params"].items()]
    moved = max(float(d.max()) for d in diffs) / lr
    far = sum(int((d > 0.1 * lr).sum()) for d in diffs) / sum(
        d.numel() for d in diffs)
    return terms, leaf, (num / den) ** 0.5, moved, far


def phase_multi_ranks(dev):
    """13d and 13e in one world of 2 ranks, each against one process on
    this device. Returns the ranks' launches summed."""
    import torch
    from deepfactors_tpu_torch import train_room_decoder as trd
    from deepfactors_tpu_torch.parallel import multihost
    backend = multi_backend(2, dev)
    setup, data, path = multi_rank_data(dev)
    # one process first, the card to itself: 6c's odometry, 11a's step and
    # the recipe, each what the world is held against
    _, poses1 = odometry_run(setup)
    step1 = train_step_run(dev, data["tree"], data["imgs"], data["gts"],
                           data["eps"])
    one = trd.main(MULTI_RECIPE_ARGV + ["--device", dev, "--out",
                                        os.path.join(MULTI_DIR,
                                                     "room256_p13_one")],
                   log=lambda *a: None)
    t0 = time.perf_counter()
    outs = multihost.World(
        [sys.executable, os.path.abspath(__file__), "--rank-task",
         "--rank-data", path, "--rank-out", os.path.join(MULTI_DIR, "ranks"),
         "--rank-device", dev, "--backend", backend], 2).wait(MULTI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"13d/13e: rank {r} exited {rc}:\n{out}"
    ranks = [torch.load(os.path.join(MULTI_DIR, f"ranks.rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    cards = _cards(dev)
    # 13d
    poses2 = ranks[0]["poses"]
    assert all(np.array_equal(x["poses"], poses2) for x in ranks)
    d_odo = float(np.abs(poses2 - poses1).max())
    assert d_odo <= MULTI_ODO_TOL, f"13d: poses {d_odo} from one process"
    odo = [x["odo_launches"]["se3_gram_batch"] for x in ranks]
    log(f"13d odometry: backend {backend}, world 2, {cards} card(s), "
        f"{ODO['frames']} frames of {len(ODO['scene_seeds'])} rooms, 4 a "
        f"rank (se3_gram_batch at P = 4): every pose within {d_odo:.3e} of "
        f"6c's one process (tol {MULTI_ODO_TOL}"
        + ("; bit-equal" if d_odo == 0 else "; not bit-equal") + "; each "
        f"rank launches with the plan of P = 8, plan_p); "
        f"se3_gram_batch launches per rank {odo}")
    # 13e, one step
    for k in ("grads", "params"):
        for n, v in ranks[0]["step"][k].items():
            assert torch.equal(v, ranks[1]["step"][k][n]), (k, n)
    terms, leaf, all_rel, moved, far = _train_spread(ranks[0]["step"], step1)
    worst = max(leaf, key=leaf.get)
    assert max(terms[k] for k in ("loss", "nll", "kl", "distill")) <= \
        MULTI_TRAIN_TERM_TOL, terms
    assert terms["grad_norm"] <= MULTI_TRAIN_NORM_TOL, terms
    assert leaf[worst] <= MULTI_TRAIN_LEAF_TOL, (worst, leaf[worst])
    assert all_rel <= MULTI_TRAIN_ALL_TOL, all_rel
    assert moved <= 2.0 * 1.001 and far <= MULTI_TRAIN_FLIP_SHARE, (moved,
                                                                    far)
    # 13e, the recipe
    nll = ranks[0]["nll"]
    assert all(np.array_equal(x["nll"], nll) for x in ranks)
    assert nll[-10:].mean() < nll[:10].mean(), nll
    w2 = np.median(ranks[0]["step_ms"][TRAIN_WARM_STEPS:])
    w1 = np.median(one["step_ms"][TRAIN_WARM_STEPS:])
    log(f"13e data-parallel training: backend {backend}, world 2, {cards} "
        f"card(s). One recipe step (11a's: batch 8 at {H}x{W}, 4 rows a "
        f"rank) against one process: terms "
        + ", ".join(f"{k} {v:.2e}" for k, v in terms.items())
        + f" (tol {MULTI_TRAIN_TERM_TOL}, the norm {MULTI_TRAIN_NORM_TOL}); "
        f"gradients all {all_rel:.2e} (tol {MULTI_TRAIN_ALL_TOL}), worst "
        f"leaf {worst} {leaf[worst]:.2e} (tol {MULTI_TRAIN_LEAF_TOL}); "
        f"parameters after the update within {moved:.3f} lr, {far:.2e} of "
        f"the elements apart by more than 0.1 lr (tol 2 lr, "
        f"{MULTI_TRAIN_FLIP_SHARE}); the two ranks' "
        f"gradients and parameters bit-identical. {MULTI_RECIPE_STEPS} "
        f"steps of 11c's recipe over the world: nll {nll[:10].mean():.4f} "
        f"(steps 0-9) -> {nll[-10:].mean():.4f} (last 10), parameters "
        f"bit-identical over the ranks; ms per step (CUDA events, median "
        f"after {TRAIN_WARM_STEPS}) world 2 {w2:.3f}, world 1 {w1:.3f} "
        f"(a reading); {wall:.1f} s; {smi_line() if dev != 'cpu' else 'cpu'}")
    return sum_counts(x["launches"] for x in ranks)


def phase_multi(dev):
    """Phase 13: 13a-13e (13c only on a card). Returns the launches of the
    phase: every rank's, summed, with 13c's world of one in this process
    (the one-process runs the ranks are held against are not counted)."""
    t_phase = time.perf_counter()
    parts = [phase_multi_demo, phase_multi_dryrun, phase_multi_ranks]
    if dev != "cpu":
        parts.insert(2, phase_multi_nccl)
    total = sum_counts([f(dev) for f in parts])
    assert set(total) == set(launch_counts()), total
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s; launches "
        f"summed over the ranks {total}")
    return total


TRACE_REPS = 20             # spans timed around one dense_warp_batch each
TRACE_TOL_US = 50.0         # each end of the device interval; host start
TRACE_SPIN_CYCLES = 4_000_000   # ~2 ms of spin queued before each span


def phase_trace(dev):
    """Phase 14: the tracer's clock (utils/timing.py). Under a profiler
    session, TRACE_REPS spans, each around one dense_warp_batch launch at
    one chunk of the large map (P = 124, 192x256) queued behind a spin:
    each end of the span's device interval lies within TRACE_TOL_US of the
    kernel's CUPTI record (so the interval holds the kernel up to that
    disagreement of the two clocks), and its host start within
    TRACE_TOL_US of its record_function mirror's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
    from deepfactors_tpu_torch.utils import timing
    t_phase = time.perf_counter()
    P, H, W = 124, 192, 256
    g = torch.Generator(device=dev).manual_seed(14)
    d = 0.01 * torch.randn((P, 6), generator=g, device=dev)
    pose = se3m.retract(se3m.identity((P,), device=dev), d)
    kp = dw.make_warp_params(pose, _smoke_camera(), 2, 0.0)
    dpt = 2.0 + 0.1 * torch.rand((P, H, W), generator=g, device=dev)
    img, gx, gy = (torch.rand((P, H, W), generator=g, device=dev)
                   for _ in range(3))
    for _ in range(5):
        dw.dense_warp_batch(kp, dpt, img, gx, gy)
    torch.cuda.synchronize()
    timing.reset_timing()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with timing.span("trace.anchor"):    # the anchor, before the spins
            pass
        for _ in range(TRACE_REPS):
            # queued behind a spin, the span's events run right before and
            # after the kernel: their gaps to its record are the clocks'
            # disagreement, not the host's launch time
            torch.cuda._sleep(TRACE_SPIN_CYCLES)
            with timing.span("trace.check"):
                dw.dense_warp_batch(kp, dpt, img, gx, gy)
            torch.cuda.synchronize()
    recs = [r for r in timing.spans() if r.name == "trace.check"]
    kernels, mirrors = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and \
                not e.is_user_annotation() and \
                "dense_warp_kernel" in e.name():
            kernels.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CPU and \
                e.name() == "trace.check":
            mirrors.append(e.start_ns())
    kernels.sort()
    mirrors.sort()
    assert len(recs) == len(kernels) == len(mirrors) == TRACE_REPS, \
        (len(recs), len(kernels), len(mirrors))
    lead, lag, host = [], [], []
    for r, (ks, ke), m in zip(recs, kernels, mirrors):
        lead.append((ks - r.dev_start_ns) / 1e3)
        lag.append((r.dev_end_ns - ke) / 1e3)
        host.append((m - r.host_start_ns) / 1e3)
    us = lambda v: (f"min {min(v):.2f} median {np.median(v):.2f} max "
                    f"{max(v):.2f} us")
    out = {"lead_us": lead, "lag_us": lag, "host_us": host,
           "kernel_us": [(e - s) / 1e3 for s, e in kernels]}
    log(f"phase 14: the span's device start before the kernel's: "
        f"{us(lead)}; its device end after the kernel's: {us(lag)}; the "
        f"record_function's start after its host start: {us(host)}; the "
        f"kernel {us(out['kernel_us'])}")
    for a, b, c in zip(lead, lag, host):
        assert abs(a) <= TRACE_TOL_US and abs(b) <= TRACE_TOL_US, \
            (lead, lag)
        assert abs(c) <= TRACE_TOL_US, host
    timing.reset_timing()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_trace_fresh():
    """Phase 14 in a process of its own (``--only-trace``): late in the
    whole script the profiler keeps only some of the kernel records (13-14
    of 20, on the parent commit too; ROADMAP E5), which would fail the
    check for a cause outside the tracer."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--only-trace"]).returncode
    assert rc == 0, f"phase 14 in its own process exited {rc}"
    log(f"phase 14 in its own process: {time.perf_counter() - t0:.1f} s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--only-demo", action="store_true",
                    help="phases 1 (build), 3 (decoder) and 10 only")
    ap.add_argument("--only-train", action="store_true",
                    help="phases 1 (build) and 11 only")
    ap.add_argument("--only-tools", action="store_true",
                    help="phases 1 (build) and 12 only")
    ap.add_argument("--only-multi", action="store_true",
                    help="phases 1 (build) and 13 only")
    ap.add_argument("--only-trace", action="store_true",
                    help="phases 1 (build) and 14 only")
    ap.add_argument("--only-jacobian", action="store_true",
                    help="phases 1 (build), 2c, 3, 6a and 6b only")
    # a rank of phase 13's world (what multihost.World starts)
    ap.add_argument("--rank-task", action="store_true",
                    help=argparse.SUPPRESS)
    for flag in ("--rank-data", "--rank-out", "--rank-device", "--backend",
                 "--coord"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--nproc", "--proc-id"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if args.rank_task:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return rank_task(args)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deepfactors_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 3
    from deepfactors_tpu_torch.ops.kernels import build

    dev = "cuda"
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    first_lib = os.path.join(str(build.build_dir()), "bilinear_warp_first.so")
    first_build = start_variant_build(FIRST_BILINEAR_SRC, first_lib)
    build_s = build.build_all(ptxas_verbose=args.ptxas)
    first_design = finish_variant_build(first_build, first_lib,
                                        "bilinear_warp_first_launch", 4, 3)
    log(f"kernel build: {build_s:.2f} s "
        + str({k: round(v['seconds'], 2) for k, v in build.build_log.items()})
        + f"; the first bilinear_warp_planes design beside it")
    if args.ptxas:
        for src, v in build.build_log.items():
            log(f"--- {src}\n{v['ptxas']}")

    if args.only_demo or args.only_train or args.only_tools or \
            args.only_multi or args.only_trace or args.only_jacobian:
        if args.only_jacobian:
            cam, levels, q, t, codes = make_pools(dev)
            out = {"jacobian_stack": phase_jacobian_stack(
                dev, 32, cam, levels[0], q, t, codes)["jacobian_stack"],
                "dry_run": phase_dryrun(dev),
                "large_map": large_map_run(large_map_setup(
                    dev, phase_decoder(dev)))}
        elif args.only_demo:
            out = {"demo_launches": phase_demo(dev, phase_decoder(dev))}
        elif args.only_train:
            out = {"train_launches": phase_train(dev)}
        elif args.only_tools:
            out = {"tools_launches": phase_tools(dev)}
        elif args.only_multi:
            out = {"multi_launches": phase_multi(dev)}
        else:
            out = {"trace": phase_trace(dev)}
        log(json.dumps(out))
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    kern = phase_kernels(dev, first_design)
    phase_rep_ops(dev)
    decoder = phase_decoder(dev)
    launches_e2e = phase_e2e(dev, decoder)
    launches_loop = phase_loop(dev, decoder)
    launches_reloc = phase_reloc(dev, decoder)
    launches_pipe = phase_pipelined(dev, decoder)
    launches = phase_long_run(dev, decoder)
    parallel = {"dry_run": phase_dryrun(dev),
                "large_map": large_map_run(large_map_setup(dev, decoder)),
                "odometry": odometry_run(odometry_setup(dev))[0]}
    par_total = {k: sum(p[k] for p in parallel.values()) for k in launches}
    assert par_total["dense_warp_batch"] > 0 < par_total["bilinear_warp_planes"]
    phase_geo_system(dev)
    phase_depth_prior(dev)
    launches_refine = phase_refine(dev, decoder)
    launches_demo = phase_demo(dev, decoder)
    launches_train = phase_train(dev)
    launches_tools = phase_tools(dev, decoder)
    launches_multi = phase_multi(dev)
    phase_trace_fresh()

    meta = {
        "se3_gram_batch": ("deepfactors_tpu_torch/csrc/se3_gram.cu",
                           "deepfactors_tpu/ops/pallas/sfm_kernel.py:680"),
        "sfm_gram_batch": ("deepfactors_tpu_torch/csrc/sfm_gram.cu",
                           "deepfactors_tpu/ops/pallas/sfm_kernel.py:545"),
        "sfm_error_batch": ("deepfactors_tpu_torch/csrc/sfm_error.cu",
                            "deepfactors_tpu/ops/pallas/sfm_kernel.py:783"),
        "se3_warp_batch": ("deepfactors_tpu_torch/csrc/sfm_error.cu",
                           "deepfactors_tpu/ops/pallas/sfm_kernel.py:874"),
        "dense_warp_batch": ("deepfactors_tpu_torch/csrc/dense_warp.cu",
                             "deepfactors_tpu/ops/pallas/warp_kernel.py:280"),
        "bilinear_warp_planes": ("deepfactors_tpu_torch/csrc/dense_warp.cu",
                                 "deepfactors_tpu/ops/pallas/warp_kernel.py:125"),
        "jacobian_stack": ("deepfactors_tpu_torch/csrc/jacobian_stack.cu",
                           "none (XLA's fusion of the Jacobian build, "
                           "deepfactors_tpu/ops/dense_sfm.py:322-392)"),
    }
    rows = []
    for name, (src, rep) in meta.items():
        r = kern[name]
        # launches: the long run (phase 5) for the four kernels it drives,
        # the parallel entry points (phase 6) for the two it does not;
        # launches_by_path gives every path's count
        by_path = {"e2e_60_frames_rep": launches_e2e[name],
                   "loop_closure": launches_loop[name],
                   "relocalisation": launches_reloc[name],
                   "pipelined": launches_pipe[name],
                   "long_run": launches[name],
                   **{k: v[name] for k, v in parallel.items()},
                   "refine": launches_refine[name],
                   **{k: v[name] for k, v in launches_demo.items()},
                   "trained_decoder": launches_train[name],
                   "tools": launches_tools[name],
                   "multi": launches_multi[name]}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": launches[name] or par_total[name],
                     "launches_by_path": by_path,
                     "max_abs_err": r["max_abs_err"],
                     "max_rel_err": r["max_rel_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"), "shape": r["shape"],
                     **{k: r[k] for k in ("by_level", "by_shape",
                                          "p8_sampled", "loop_ps",
                                          "empty_launch_ms", "ms_is",
                                          "in_context")
                        if k in r}})
    log(json.dumps({"kernels": rows}))
    log(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
