"""The DeepFactors system facade: the per-frame SLAM pipeline.

PyTorch port of ``deepfactors_tpu/system.py`` (reference
sources/core/deepfactors.{h,cpp}). Per frame (ProcessFrame,
deepfactors.cpp:220-366):

  preprocess -> (lost: relocalise) -> keyframe selection -> frame step
  (pyramids + C2F tracking + features and BoW + decision probe, one host
  read) -> CheckTrackingLost -> loop closure (local photometric link,
  global loop by BoW retrieval and batched dense verification)
  -> NewKeyframeRequired? EnqueueKeyframe : NewFrameRequired? EnqueueFrame
  -> mapping until no work (or one run if interleave_mapping)

A run may outlive its keyframe window: the mapper evicts the oldest
keyframe that the facade does not protect (the tracker's keyframe and the
two newest), and the facade observes each eviction through the mapper's
``evict_callback``, which moves the keyframe's loop data into the loop
detector's archive. A lost frame relocalises against every live keyframe
at once, then against the archive (resurrecting the matched keyframe).

Pipelined mode (``pipeline_depth`` = N >= 1) keeps N frames in flight: a
frame is dispatched (its upload through pinned memory, the constant-velocity
prediction chained on the previous dispatch's device pose, its probe copied
to pinned host memory behind a CUDA event), and the frame N back is
retired: its event waited on, its probe read, its decisions made. Nothing
between two dispatches reads the device. Decisions lag N frames (the
reference's asynchronous mapping thread, live_demo.cpp:236-267); the
keyframe policy looks ahead by the camera's measured distance rate, and a
frame dispatched before the latest map mutation (keyframe built, evicted or
resurrected) keeps its pose but drives no policy (``stale``). Call
``flush()`` after the last frame.

Snapshot semantics: a dispatched frame must read the keyframe pools and
poses as they stood at its dispatch, while a retire writes them in place
(``mapping/map_state.py``). On the card the dispatched frame's kernels are
queued on the current stream before the retire's writes, so stream order
gives those reads; on the CPU the frame is computed eagerly at dispatch.
Both hold only while all of the facade's work stays on the current stream
and nothing reads a pool on the host between a dispatch and its retire.

The I/O drivers (resizing, undistortion) come with a later slice; a frame
of another size raises ``NotImplementedError``.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import configure_numerics
from . import frame_step as fs
from .features import detector as det
from .geometry import se3 as se3m
from .geometry.camera import PinholeCamera
from .geometry.se3 import SE3
from .loop.loop_detector import LoopConfig, LoopDetector, _make_verify_fn
from .mapping.mapper import Mapper, MapperConfig
from .ops import image as ip
from .ops.kernels import build
from .tracking.tracker import CameraTracker, TrackerConfig
from .utils.timing import tic, toc

Tensor = torch.Tensor


class SystemConfig(NamedTuple):
    """DeepFactorsOptions equivalent (deepfactors_options.h:28-116)."""

    mapper: MapperConfig = MapperConfig()
    tracking_iterations: tuple = (10, 5, 4)
    tracking_mode: str = "CLOSEST"        # CLOSEST | LAST | FIRST
    tracking_huber_delta: float = 0.3
    tracking_error_threshold: float = 0.3
    tracking_dist_threshold: float = 2.0
    # minimum valid-warp fraction for a pose to count as tracked at all
    min_tracking_inliers: float = 0.25
    keyframe_mode: str = "AUTO"           # AUTO | AUTO_COMBINED | NEVER
    inlier_threshold: float = 0.5
    dist_threshold: float = 2.0
    frame_dist_threshold: float = 0.2
    combined_threshold: float = 2.0
    # loop closure (deepfactors_options.h:64-70)
    loop_closure: bool = True
    loop_max_dist: float = 0.5
    loop_active_window: int = 10
    # loop-prior sigma [m / rad]: weight 1/sigma^2 against photometric
    # Hessians of ~1e3, so that the verified pose out-weighs the window
    loop_sigma: float = 0.05
    loop_min_similarity: float = 0.35
    loop_max_candidates: int = 10
    # frames to wait after an accepted global loop before detecting again
    # (consecutive frames of a revisit all match the same target)
    loop_cooldown: int = 5
    loop_archive_cap: int = 64    # archive of evicted keyframes (0: none)
    interleave_mapping: bool = False
    # a flag of the reference's options that no code reads, in the JAX
    # package as here; kept so that a flag file maps field by field
    predict_code: bool = True
    # frame pipelining: 0 = sequential (one blocking probe read per frame);
    # N >= 1 = N frames in flight, decisions N frames late (see the module
    # docstring)
    pipeline_depth: int = 0
    # live-frame upload dtype: "f32" | "f16" | "u8", widened to f32 on the
    # device. f16 and u8 shrink the one large per-frame upload, but the JAX
    # package measured both costing tracking robustness at fast pacing
    # (quantisation noise in the Sobel gradients); u8 suits 8-bit cameras
    frame_upload: str = "f32"


class Stats(NamedTuple):
    inliers: float
    tracker_error: float
    distance: float


class _InFlight(NamedTuple):
    """A dispatched frame awaiting its retire (pipelined mode)."""
    timestamp: float
    nframe: int
    img: np.ndarray          # preprocessed host frame
    out: fs.FrameStepOut
    kf: int                  # the keyframe it was tracked against
    probe: Tensor            # host copy of out.probe (pinned on the card)
    event: Optional[torch.cuda.Event]   # completes with that copy


def _host_pose(pose: SE3) -> SE3:
    return SE3(pose.q.detach().cpu().numpy(), pose.t.detach().cpu().numpy())


def _host_pose_distance(pa: SE3, pb: SE3) -> float:
    """Host-numpy mirror of se3.pose_distance (trs_wgt 8, rot_wgt 3, roll
    ignored — warping.h:139-147) for poses already on the host; the
    pipelined retire path needs one distance without a device dispatch."""
    qa = np.asarray(pa.q, np.float64)
    ta = np.asarray(pa.t, np.float64)
    qb = np.asarray(pb.q, np.float64)
    tb = np.asarray(pb.t, np.float64)
    # rel = a⁻¹ ∘ b : q_rel = conj(qa) * qb, t_rel = R(qa)ᵀ (tb - ta)
    w1, x1, y1, z1 = qa[0], -qa[1], -qa[2], -qa[3]
    w2, x2, y2, z2 = qb
    qr = np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])
    d = tb - ta
    # rotate d by conj(qa): v' = v + 2*s*(u×v) + 2*u×(u×v), u = -qa[1:]
    u = -qa[1:]
    s = qa[0]
    c1 = np.cross(u, d)
    t_rel = d + 2.0 * s * c1 + 2.0 * np.cross(u, c1)
    # so3_log(qr): w_vec = angle * axis
    nv = float(np.linalg.norm(qr[1:]))
    if nv < 1e-12:
        drot = 0.0
    else:
        ang = 2.0 * np.arctan2(nv, abs(float(qr[0])))
        wv = qr[1:] / nv * ang
        drot = float(np.linalg.norm(wv[:2]))   # roll ignored
    return 8.0 * float(np.linalg.norm(t_rel)) + 3.0 * drot


def to_gray_float(img) -> np.ndarray:
    """BGR/RGB uint8 or float image -> grayscale float32 in [0, 1]
    (deepfactors.cpp:648-655)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 3:
        img = img @ np.asarray([0.114, 0.587, 0.299], np.float32)  # BGR
    return img.astype(np.float32)


class DeepFactors:
    """System facade (deepfactors.h:53-188), on ``device``."""

    def __init__(self, cfg: SystemConfig, cam: PinholeCamera, decoder=None,
                 vocabulary=None, device="cuda"):
        if cfg.pipeline_depth < 0:
            raise ValueError(f"pipeline_depth {cfg.pipeline_depth} < 0")
        if cfg.frame_upload not in ("f32", "f16", "u8"):
            raise ValueError(f"frame_upload {cfg.frame_upload!r}: one of "
                             "'f32', 'f16', 'u8'")
        configure_numerics()
        self.cfg = cfg
        self.cam = cam
        self.device = torch.device(device)
        m = cfg.mapper
        self.mapper = Mapper(m, cam, decoder=decoder, device=self.device)
        self.mapper.evict_callback = self._on_keyframe_evicted
        self.tracker = CameraTracker(
            TrackerConfig(
                pyramid_levels=m.pyramid_levels,
                iterations_per_level=cfg.tracking_iterations[:m.pyramid_levels],
                huber_delta=cfg.tracking_huber_delta),
            cam, device=self.device)
        L = m.pyramid_levels
        self.loop_detector = LoopDetector(
            LoopConfig(max_dist=cfg.loop_max_dist,
                       active_window=cfg.loop_active_window,
                       min_similarity=cfg.loop_min_similarity,
                       max_candidates=cfg.loop_max_candidates,
                       iters_per_level=cfg.tracking_iterations[:L],
                       huber_delta=cfg.tracking_huber_delta),
            cam, L, m.max_keyframes, voc=vocabulary,
            archive_cap=cfg.loop_archive_cap, device=self.device,
        ) if cfg.loop_closure else None
        # relocalisation: the loop detector's batched verification over the
        # whole keyframe pool (P = K) or the archive (P = archive_cap)
        self._reloc_fn = _make_verify_fn(
            LoopConfig(iters_per_level=cfg.tracking_iterations[:L],
                       huber_delta=cfg.tracking_huber_delta,
                       grad_mode=self.tracker.cfg.grad_mode), cam, L)
        self._frame_fn = fs.build_frame_fn(
            self.tracker.cfg, cam, L,
            with_loop=self.loop_detector is not None,
            det_cfg=det.DetectorConfig(max_keypoints=max(m.max_keypoints, 64)))
        S = m.max_keyframes + (self.loop_detector.A
                               if self.loop_detector is not None else 0)
        self._probe_off, _ = fs.probe_layout(m.max_keyframes, m.max_frames, S)
        # callbacks (deepfactors.h:114-116): fn(pose_wc) per tracked frame,
        # fn(map state) after a keyframe's refinement, fn(Stats) per
        # non-keyframe frame
        self.pose_callback = None
        self.map_callback = None
        self.stats_callback = None
        self.reset()

    def reset(self):
        self.mapper.reset()
        self.tracker.reset()
        if self.loop_detector is not None:
            self.loop_detector.reset()
        self.bootstrapped = False
        self.tracking_lost = False
        self.force_keyframe_flag = False
        self.force_frame_flag = False
        self.curr_kf: Optional[int] = None
        self.pose_wc = SE3(np.array([1.0, 0, 0, 0], np.float32),
                           np.zeros(3, np.float32))
        self.stats = Stats(0.0, float("inf"), 0.0)
        self.trajectory: list = []   # (timestamp, SE3 pose_wc) host numpy
        self.loop_links: list = []   # (kf slot, slot or ("arch", index))
        # previous frame's probe distances (CLOSEST keyframe selection)
        self._last_kf_dists: Optional[np.ndarray] = None
        # previous frame's world pose: constant-velocity tracking init
        self._pose_wc_prev: Optional[SE3] = None
        # per-frame velocity reconstructed across a relocalisation: without
        # it a recovery restarts at zero velocity and loses the next frame
        self._reloc_vel: Optional[SE3] = None
        self._last_tracked_nframe = 0
        self._last_loop_nframe = -10**9
        self.n_frames = 0
        self.n_lost_frames = 0        # frames dropped while lost
        self.n_relocalizations = 0    # successful relocalisations
        self.n_evictions = 0
        # which of the three loop paths fired
        self.n_local_links = 0        # photometric local links
        self.n_live_global_loops = 0  # prior + rep link (live target)
        self.n_archived_loops = 0     # prior (archived target)
        # pipelined mode: frames in flight and the constant-velocity chain
        # on device poses (see _dispatch_frame)
        self._pending: deque = deque()
        self._dev_prev = None         # (q, t) device tensors, or None
        self._dev_prev2 = None
        self._chain_vel: Optional[SE3] = None  # one-shot post-reloc velocity
        self._map_mutation_nframe = 0  # last keyframe build/evict/resurrect
        self._newest_kf_pose: Optional[SE3] = None  # host pose, newest kf
        self._d_rate = 0.0            # EMA of the per-frame kf-distance rate
        self._last_kf_dist = float("nan")

    def _dev(self, x) -> torch.Tensor:
        """A host pose component on the device, without a stream sync."""
        return fs.to_device(np.asarray(x, np.float32), self.device)

    def _reset_chain(self):
        self._pending.clear()
        self._dev_prev = self._dev_prev2 = self._chain_vel = None

    # ------------------------------------------------------------------
    # bootstrap (deepfactors.cpp:370-443)
    # ------------------------------------------------------------------

    def bootstrap_two_frames(self, img0, img1, frame_gap: int = 1):
        """Two-frame photometric bootstrap. ``frame_gap`` (source frames
        between img0 and img1) turns the estimated baseline into the
        per-frame velocity that seeds the constant-velocity chain."""
        tic("bootstrap")
        s0, s1 = self.mapper.init_two_frames(to_gray_float(img0),
                                             to_gray_float(img1))
        self.mapper.update_map()
        self._set_tracker_keyframe(s1)
        self.curr_kf = s1
        pose = self.mapper.state.pose
        self.pose_wc = _host_pose(se3m.index(pose, s1))
        if self.loop_detector is not None:
            for s in (s0, s1):
                self._loop_add_keyframe(s)
        self.bootstrapped = True
        self.tracking_lost = False
        rel = se3m.mul(se3m.inverse(se3m.index(pose, s0)),
                       se3m.index(pose, s1))
        g = max(1, int(frame_gap))
        vel = SE3(se3m.so3_exp_quat(se3m.so3_log(rel.q) / g), rel.t / g)
        p2 = se3m.mul(SE3(self._dev(self.pose_wc.q), self._dev(self.pose_wc.t)),
                      se3m.inverse(vel))
        self._pose_wc_prev = _host_pose(p2)
        self._reloc_vel = None
        self._reset_chain()
        self._last_tracked_nframe = self.n_frames
        toc("bootstrap")

    def bootstrap_one_frame(self, img):
        """Bootstrap on one keyframe at the identity pose (the JAX
        ``bootstrap_one_frame``); tracking starts at zero velocity."""
        s = self.mapper.init_one_frame(to_gray_float(img))
        self.mapper.update_map()
        self._set_tracker_keyframe(s)
        self.curr_kf = s
        self.pose_wc = SE3(np.array([1.0, 0, 0, 0], np.float32),
                           np.zeros(3, np.float32))
        if self.loop_detector is not None:
            self._loop_add_keyframe(s)
        self.bootstrapped = True
        self.tracking_lost = False
        self._pose_wc_prev = None
        self._reset_chain()

    # ------------------------------------------------------------------
    # per-frame pipeline (deepfactors.cpp:220-366)
    # ------------------------------------------------------------------

    def process_frame(self, timestamp: float, img) -> None:
        """ProcessFrame (deepfactors.cpp:220-366). With
        ``cfg.pipeline_depth > 0`` this dispatches the frame, then retires
        the frame ``pipeline_depth`` frames back: call :meth:`flush` after
        the last frame to retire the tail."""
        if not self.bootstrapped:
            raise RuntimeError(
                "Calling ProcessFrame before system is bootstrapped!")
        tic("preprocess")
        img = self.preprocess_image(img)
        toc("preprocess")
        self.n_frames += 1
        nframe = self.n_frames
        just_relocalized = False
        if self.tracking_lost:
            # frames in flight behind a loss chained off the lost pose:
            # retire (discard) them first
            self.flush()
            tic("relocalize")
            ok = self._relocalize(img)
            toc("relocalize")
            if not ok:
                self.n_lost_frames += 1
                return          # stay lost; retry next frame
            self.n_relocalizations += 1
            self.tracking_lost = False
            just_relocalized = True
            # fall through: the frame step refines from the relocalised pose
        # keyframe selection before tracking, from the previous frame's
        # probe distances; not after a relocalisation, which just chose the
        # keyframe by appearance
        if not just_relocalized:
            newkf = self._select_keyframe()
            if newkf != self.curr_kf:
                self._set_current_kf(newkf)
        tic("frame step")
        out = self._dispatch_frame(img, just_relocalized)
        if self.cfg.pipeline_depth > 0:
            probe, event = self._probe_copy(out.probe)
            self._pending.append(_InFlight(timestamp, nframe, img, out,
                                           self.curr_kf, probe, event))
            toc("frame step")
            while len(self._pending) > self.cfg.pipeline_depth:
                self._retire_one()
            return
        probe, new_pose_wc = self._parse_probe(out.probe.cpu().numpy())
        toc("frame step")
        self._decide(timestamp, nframe, img, out, probe, new_pose_wc,
                     self.curr_kf, stale=False)

    def flush(self) -> None:
        """Retire every frame in flight (pipelined mode). Call after the
        last process_frame of a sequence: the trajectory and the map are
        final only once the pipeline is drained. No-op in sequential
        mode."""
        while self._pending:
            self._retire_one()

    def _probe_copy(self, probe: Tensor):
        """Start the probe's copy to the host: on the card into pinned
        memory behind the stream's queue, with an event that completes
        with the copy (read the buffer only after ``event.synchronize()``:
        before, it holds whatever the allocator left there). On the CPU the
        probe is already on the host."""
        if probe.device.type != "cuda":
            return probe, None
        host = torch.empty(probe.shape, dtype=probe.dtype, pin_memory=True)
        host.copy_(probe, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _dispatch_frame(self, img, just_relocalized: bool = False):
        """Run the frame step. Sequential mode seeds the constant-velocity
        prediction from the host poses; pipelined mode chains it on the
        previous dispatch's device pose outputs (wc_q/wc_t), so that no host
        read sits between two dispatches. The keyframe slot is a Python int
        (basic indexing of the pools): unlike the JAX package, nothing
        needs a cached device scalar."""
        st = self.mapper.state
        fsd = self.mapper.frames
        L = self.cfg.mapper.pyramid_levels
        pipelined = self.cfg.pipeline_depth > 0
        if pipelined and just_relocalized:
            # restart the chain at the relocalised pose; the velocity
            # reconstructed across the lost gap applies from the NEXT
            # dispatch (this frame re-tracks from the relocalised pose)
            self._dev_prev = (self._dev(self.pose_wc.q),
                              self._dev(self.pose_wc.t))
            self._dev_prev2 = None
            self._chain_vel = self._reloc_vel
            self._reloc_vel = None
        if pipelined and self._dev_prev is not None:
            prev_q, prev_t = self._dev_prev
            if self._chain_vel is not None:
                # prev2 = prev ∘ vel⁻¹, so that the prediction is prev ∘ vel
                v = self._chain_vel
                self._chain_vel = None
                p2 = se3m.mul(SE3(prev_q, prev_t),
                              se3m.inverse(SE3(self._dev(v.q),
                                               self._dev(v.t))))
                prev2_q, prev2_t = p2.q, p2.t
            elif self._dev_prev2 is not None:
                prev2_q, prev2_t = self._dev_prev2
            else:
                prev2_q, prev2_t = prev_q, prev_t
        else:
            prev2 = self._pose_wc_prev if self._pose_wc_prev is not None \
                else self.pose_wc
            prev_q = self._dev(self.pose_wc.q)
            prev_t = self._dev(self.pose_wc.t)
            prev2_q, prev2_t = self._dev(prev2.q), self._dev(prev2.t)
        ld = self.loop_detector
        loop = (ld.voc, ld.db, ld.db_valid) if ld is not None else ()
        out = self._frame_fn(
            self._upload_dtype(img),
            tuple(st.levels[l].img for l in range(L)),
            tuple(st.levels[l].dpt for l in range(L)),
            st.pose.q, st.pose.t, fsd.pose.q, fsd.pose.t, self.curr_kf,
            prev_q, prev_t, prev2_q, prev2_t, *loop)
        if pipelined:
            self._dev_prev2 = (prev_q, prev_t)
            self._dev_prev = (out.wc_q, out.wc_t)
        return out

    def _upload_dtype(self, img: np.ndarray) -> np.ndarray:
        """The host frame in ``cfg.frame_upload``'s dtype."""
        if self.cfg.frame_upload == "u8" and img.dtype != np.uint8:
            return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if self.cfg.frame_upload == "f16" and img.dtype != np.float16:
            return img.astype(np.float16)
        return img

    def _retire_one(self) -> None:
        """Retire the oldest frame in flight: wait for its probe's copy,
        read it, and make every decision the sequential path makes after
        the frame step."""
        e = self._pending.popleft()
        if self.tracking_lost:
            # a newer retire declared a loss while this frame was in
            # flight: its tracking chained off the lost pose
            self.n_lost_frames += 1
            return
        tic("probe retire")
        if e.event is not None:
            e.event.synchronize()
        probe, new_pose_wc = self._parse_probe(e.probe.numpy())
        toc("probe retire")
        # a frame dispatched before the latest map mutation (keyframe
        # build, eviction, resurrection) carries distances and similarities
        # over the pools as they were: its pose counts, but no policy may
        # act on its stale slots (a d_full entry of a reused slot would
        # re-fire the keyframe policy at every event)
        stale = e.nframe <= self._map_mutation_nframe
        self._decide(e.timestamp, e.nframe, e.img, e.out, probe, new_pose_wc,
                     e.kf, stale=stale)

    def _decide(self, timestamp, nframe, img, out, probe, new_pose_wc,
                kf: int, stale: bool = False) -> None:
        """Post-tracking decisions for one frame: lost check, CV chain
        bookkeeping, loop closure, keyframe/frame policies, mapping. ``kf``
        is the keyframe the frame was tracked against (curr_kf at its
        dispatch); a ``stale`` frame (pipelined mode) drives no policy."""
        self.tracker.inliers = probe["inliers"]
        self.tracker.error = probe["error"]
        if not stale:
            self._last_kf_dists = probe["d_full"]
        dist = float(probe["d_full"][kf])
        # per-frame keyframe-distance rate (EMA) for the keyframe policy's
        # lookahead: pipelined decisions act pipeline_depth frames late
        if np.isfinite(dist) and np.isfinite(self._last_kf_dist):
            rate = max(0.0, dist - self._last_kf_dist)
            if rate < self.cfg.dist_threshold:   # divergence is not motion
                self._d_rate = 0.7 * self._d_rate + 0.3 * rate
        self._last_kf_dist = dist
        if stale and self._newest_kf_pose is not None:
            # a keyframe was built after this frame's dispatch: the distance
            # to the old reference keyframe overstates how far the camera
            # is from the map
            dist = min(dist, _host_pose_distance(self._newest_kf_pose,
                                                 new_pose_wc))
        self.tracking_lost = self._check_tracking_lost(probe, kf, dist)
        if self.tracking_lost:
            self._pose_wc_prev = None   # a stale velocity would mislead
            self._reloc_vel = None
            self._dev_prev = self._dev_prev2 = self._chain_vel = None
            self.n_lost_frames += 1
            return
        if self._reloc_vel is not None:
            # re-seed the constant-velocity chain with the motion estimated
            # across the relocalisation gap: prev2 = cur * vel^-1 makes the
            # next prediction cur * vel instead of zero velocity
            v = self._reloc_vel
            self._pose_wc_prev = _host_pose(se3m.mul(
                SE3(self._dev(new_pose_wc.q), self._dev(new_pose_wc.t)),
                se3m.inverse(SE3(self._dev(v.q), self._dev(v.t)))))
            self._reloc_vel = None
        else:
            self._pose_wc_prev = self.pose_wc
        self.pose_wc = new_pose_wc
        self._last_tracked_nframe = nframe
        self.trajectory.append((timestamp, new_pose_wc))
        if self.pose_callback:
            self.pose_callback(new_pose_wc)

        if self.loop_detector is not None and not stale:
            tic("loop closure")
            self._loop_closure(out.img_pyr, out.grad_pyr, probe, out.feat, kf)
            toc("loop closure")

        if not stale and self._new_keyframe_required(probe, kf):
            tic("enqueue keyframe")
            slot = self.mapper.enqueue_keyframe(
                img, self.pose_wc, pyramids_in=(out.img_pyr, out.grad_pyr))
            self._set_current_kf(slot)
            self._map_mutation_nframe = self.n_frames
            self._newest_kf_pose = self.pose_wc
            # the rate's baseline: the new keyframe sits at this frame's
            # pose, so the next frame's distance to it is the rate
            self._last_kf_dist = 0.0
            # the new keyframe sits at the camera pose: closest by
            # construction (the cached distances predate it)
            if self._last_kf_dists is not None:
                self._last_kf_dists = np.array(self._last_kf_dists, copy=True)
                self._last_kf_dists[slot] = 0.0
            if self.loop_detector is not None:
                self._loop_add_keyframe(slot)
            # refine the fresh keyframe now: tracking the next frame against
            # unrefined predicted depth can diverge
            while self.mapper.has_work():
                self.mapper.mapping_run()
            self.mapper.update_map()
            if self.map_callback:
                self.map_callback(self.mapper.state)
            toc("enqueue keyframe")
            return

        if not stale and self._new_frame_required(probe, kf):
            self.mapper.enqueue_frame(img, self.pose_wc, kf,
                                      pyramids=(out.img_pyr, out.grad_pyr))

        self.stats = Stats(inliers=probe["inliers"],
                           tracker_error=probe["error"],
                           distance=float(probe["d_full"][kf]))
        if self.stats_callback:
            self.stats_callback(self.stats)

        if self.mapper.has_work():
            tic("mapping")
            while True:
                self.mapper.mapping_run()
                if not self.mapper.has_work() or self.cfg.interleave_mapping:
                    break
            self.mapper.update_map()
            toc("mapping")

    def _parse_probe(self, pv: np.ndarray):
        """Unpack the probe vector (frame_step.probe_layout) into the
        decision dict + the tracked world pose (host numpy)."""
        o = self._probe_off
        sl = lambda n: pv[o[n][0]:o[n][1]]
        tail = sl("tail")
        probe = {"d_full": sl("d_full"), "d_trans": sl("d_trans"),
                 "fr_trans": sl("fr_trans"), "sims": sl("sims"),
                 "rot": float(tail[0]), "inliers": float(tail[1]),
                 "error": float(tail[2])}
        return probe, SE3(sl("wc_q").copy(), sl("wc_t").copy())

    def _set_current_kf(self, slot: int):
        """Switch the active tracking keyframe (the frame step indexes the
        map pool directly, so nothing is copied)."""
        self.curr_kf = slot
        self._protect(slot)

    def _protect(self, slot: int):
        """The tracker's keyframe and the two newest map keyframes must
        survive capacity eviction."""
        self.mapper.protected_slots = {slot} | set(self.mapper.kf_slots[-2:])

    def _on_keyframe_evicted(self, slot: int, kf_id: int):
        """The mapper's ``evict_callback``, before the slot is reused: the
        loop detector moves the keyframe's loop data (BoW row, level-0
        image and depth, final pose) into its archive, so that a revisit
        can still close a loop against it. Counts the evictions."""
        self.n_evictions += 1
        if self.loop_detector is not None:
            self.loop_detector.archive_keyframe(slot, kf_id, self.mapper.state)

    def _set_tracker_keyframe(self, slot: int):
        L = self.cfg.mapper.pyramid_levels
        st = self.mapper.state
        self.tracker.set_keyframe([st.levels[l].img[slot] for l in range(L)],
                                  [st.levels[l].dpt[slot] for l in range(L)],
                                  se3m.index(st.pose, slot))
        self._protect(slot)

    def preprocess_image(self, img) -> np.ndarray:
        """PreprocessImage (deepfactors.cpp:634-680): grayscale float in
        [0, 1] at the configured size."""
        img = to_gray_float(img)
        H, W = self.cfg.mapper.height, self.cfg.mapper.width
        if img.shape != (H, W):
            raise NotImplementedError(
                f"frame is {img.shape}, the system runs at {(H, W)}: resizing "
                "and undistortion come with the I/O slice of the port")
        return img

    # ------------------------------------------------------------------
    # policies (deepfactors.cpp:747-879)
    # ------------------------------------------------------------------

    def _select_keyframe(self) -> int:
        """SelectKeyframe (deepfactors.cpp:813-848); CLOSEST uses the
        previous frame's probe distances."""
        mode = self.cfg.tracking_mode
        slots = self.mapper.kf_slots
        if mode == "LAST":
            return slots[-1]
        if mode == "FIRST":
            return slots[0]
        d = self._last_kf_dists
        if d is None:
            d = se3m.pose_distance(
                self.mapper.state.pose,
                SE3(self._dev(self.pose_wc.q), self._dev(self.pose_wc.t)),
            ).cpu().numpy()
        best, bd = slots[-1], np.inf
        for s in slots:
            if s < len(d) and d[s] < bd:
                best, bd = s, float(d[s])
        return best

    def _check_tracking_lost(self, probe: dict, kf: int = None,
                             dist: float = None) -> bool:
        """CheckTrackingLost (deepfactors.cpp:852-879); non-finite error or
        distance (a diverged alignment) counts as lost."""
        err = float(probe["error"])
        if dist is None:
            dist = float(probe["d_full"][self.curr_kf if kf is None else kf])
        error_too_big = (not np.isfinite(err)
                         or err > self.cfg.tracking_error_threshold)
        kf_too_far = (not np.isfinite(dist)
                      or dist > self.cfg.tracking_dist_threshold)
        low_overlap = float(probe["inliers"]) < self.cfg.min_tracking_inliers
        return bool(error_too_big or kf_too_far or low_overlap)

    def _new_keyframe_required(self, probe: dict, kf: int = None) -> bool:
        if self.force_keyframe_flag:
            self.force_keyframe_flag = False
            return True
        mode = self.cfg.keyframe_mode
        if mode == "NEVER":
            return False
        inliers = probe["inliers"]
        distance = float(probe["d_full"][self.curr_kf if kf is None else kf])
        # pipelined lookahead: decisions act pipeline_depth frames late (and
        # the event lands one frame later still), so the distance policy
        # fires early by the measured per-frame rate, and the keyframe
        # spacing matches the sequential mode's
        lead = self.cfg.pipeline_depth
        thresh = self.cfg.dist_threshold
        if lead > 0 and np.isfinite(self._d_rate):
            thresh = max(0.5 * thresh, thresh - lead * self._d_rate)
        if mode == "AUTO":
            return inliers < self.cfg.inlier_threshold or distance > thresh
        delta = distance * 5 + probe["rot"] * 3
        return (delta > self.cfg.combined_threshold
                or inliers < self.cfg.inlier_threshold)

    def _new_frame_required(self, probe: dict, kf: int = None) -> bool:
        if self.force_frame_flag:
            self.force_frame_flag = False
            return True
        if self.cfg.keyframe_mode == "NEVER":
            return False
        far_from_kf = (float(probe["d_trans"][self.curr_kf if kf is None
                                              else kf])
                       > self.cfg.frame_dist_threshold)
        far_from_frames = True
        m = self.mapper
        for i in range(len(m.frame_active_host)):
            if m.frame_active_host[i] and not m.frame_marg_host[i]:
                if float(probe["fr_trans"][i]) < self.cfg.frame_dist_threshold:
                    far_from_frames = False
        return far_from_kf and far_from_frames and not self.mapper.has_work()

    # ------------------------------------------------------------------
    # relocalisation (deepfactors.cpp:713-743)
    # ------------------------------------------------------------------

    def _relocalize(self, img: np.ndarray) -> bool:
        """Relocalize (deepfactors.cpp:713-743): dense tracking of the frame
        against EVERY keyframe slot at once (the loop detector's batched
        verification, P = max_keyframes), one host read; the best live
        keyframe by error among the acceptable ones wins, else the archive
        is tried. On success sets pose_wc and curr_kf and returns True."""
        L = self.cfg.mapper.pyramid_levels
        img_pyr = tuple(ip.build_pyramid(fs.upload_frame(img, self.device), L))
        grad_pyr = tuple(ip.build_gradient_pyramid(img_pyr))
        st = self.mapper.state
        ident = se3m.identity((self.cfg.mapper.max_keyframes,),
                              device=self.device)
        packed = self._reloc_fn(
            tuple(st.levels[l].img for l in range(L)),
            tuple(st.levels[l].dpt for l in range(L)),
            img_pyr, grad_pyr, ident.q, ident.t)
        pk = packed.cpu().numpy()
        kq, kt = st.pose.q.cpu().numpy(), st.pose.t.cpu().numpy()
        q, t, inl, err = pk[:, 0:4], pk[:, 4:7], pk[:, 7], pk[:, 8]
        best, best_err = -1, np.inf
        for s in self.mapper.kf_slots:
            if err[s] < best_err and self._acceptable(err[s], inl[s], q[s],
                                                       t[s]):
                best, best_err = s, float(err[s])
        if best < 0:
            # no live keyframe matches: the camera often re-enters territory
            # whose keyframes were marginalised out long ago
            return self._relocalize_archived(img_pyr, grad_pyr)
        # pose_wc = pose_wk * pose_ck^-1
        wc = se3m.mul(SE3(self._dev(kq[best]), self._dev(kt[best])),
                      se3m.inverse(SE3(self._dev(q[best]),
                                       self._dev(t[best]))))
        # the per-frame velocity across the lost gap, from the last tracked
        # pose: a restart at zero velocity cannot cover the inter-frame
        # motion at fast pacing and goes lost again at once
        old = self.pose_wc
        gap = max(1, self.n_frames - self._last_tracked_nframe)
        self._reloc_vel = None
        if gap <= 5:
            rel = se3m.mul(se3m.inverse(SE3(self._dev(old.q),
                                            self._dev(old.t))), wc)
            w = se3m.so3_log(rel.q)
            vw = se3m.so3_exp_quat(w / gap).cpu().numpy()
            vt = rel.t.cpu().numpy() / gap
            w = w.cpu().numpy()
            # a garbage last-tracked pose must not inject a wild velocity
            # (> ~0.5 rad or 0.5 m per frame)
            if (np.isfinite(vt).all() and np.isfinite(vw).all()
                    and np.linalg.norm(vt) < 0.5
                    and np.linalg.norm(w) / gap < 0.5):
                self._reloc_vel = SE3(vw, vt)
        self.pose_wc = _host_pose(wc)
        self._set_current_kf(best)
        self._last_kf_dists = None
        self._pose_wc_prev = None
        self.tracker.error = best_err
        return True

    def _acceptable(self, e, i, qr, tr) -> bool:
        """A recovered pose camera <- keyframe is accepted when its error
        and valid share pass the tracking thresholds and it lands NEAR the
        keyframe: a sliver-overlap minimum can score a tiny error metres
        away."""
        ang = 2.0 * np.arccos(np.clip(abs(float(qr[0])), 0.0, 1.0))
        d_ck = 8.0 * float(np.linalg.norm(tr)) + 3.0 * ang
        return bool(np.isfinite(e) and e <= self.cfg.tracking_error_threshold
                    and i >= self.cfg.min_tracking_inliers
                    and np.isfinite(tr).all()
                    and d_ck <= self.cfg.tracking_dist_threshold)

    def _arch_verify(self, img_pyr, grad_pyr, ld=None) -> Tensor:
        """Batched dense verification of a frame against the whole archive
        of ``ld`` (the loop detector unless given; P = archive_cap), the
        pyramids rebuilt by blur-down. [A, 9]."""
        ld = self.loop_detector if ld is None else ld
        imgs, dpts = [ld.arch_img], [ld.arch_dpt]
        for _ in range(1, self.cfg.mapper.pyramid_levels):
            imgs.append(ip.gaussian_blur_down(imgs[-1]))
            dpts.append(ip.gaussian_blur_down(dpts[-1]))
        ident = se3m.identity((ld.A,), device=self.device)
        return self._reloc_fn(imgs, dpts, img_pyr, grad_pyr, ident.q, ident.t)

    def _relocalize_archived(self, img_pyr, grad_pyr) -> bool:
        """Relocalize against the archive of evicted keyframes and
        resurrect the match into the live pool: the archived keyframe is
        rebuilt as a live keyframe at its archived pose, pinned by a pose
        prior (its factors are gone; the prior carries its information),
        and tracking resumes from it. The reference keeps every keyframe
        live in ISAM2 and never needs this."""
        ld = self.loop_detector
        if ld is None or ld.A == 0:
            return False
        valid = ld.arch_ids >= 0
        if not valid.any():
            return False
        pk = self._arch_verify(img_pyr, grad_pyr).cpu().numpy()
        q, t, inl, err = pk[:, 0:4], pk[:, 4:7], pk[:, 7], pk[:, 8]
        best, best_err = -1, np.inf
        for a in range(ld.A):
            if (valid[a] and err[a] < best_err
                    and self._acceptable(err[a], inl[a], q[a], t[a])):
                best, best_err = a, float(err[a])
        if best < 0:
            return False
        # read before an eviction below can overwrite the archive entry
        aq = ld.arch_q[best].cpu().numpy()
        at = ld.arch_t[best].cpu().numpy()
        aimg = ld.arch_img[best].cpu().numpy()
        wk = SE3(aq, at)
        wc = se3m.mul(SE3(self._dev(aq), self._dev(at)),
                      se3m.inverse(SE3(self._dev(q[best]),
                                       self._dev(t[best]))))
        m = self.mapper
        if len(m.kf_slots) >= self.cfg.mapper.max_keyframes:
            m.marginalize_keyframe(m._select_victim())
        slot = m.add_keyframe_to_map(aimg, wk)
        self._map_mutation_nframe = self.n_frames
        m.add_loop_prior(slot, wk, sigma=self.cfg.loop_sigma)
        self._loop_add_keyframe(slot)
        # the live row supersedes the archive row
        ld.arch_ids[best] = -1
        ld.db_valid[ld.K + best] = False
        self.pose_wc = _host_pose(wc)
        self._set_current_kf(slot)
        self._last_kf_dists = None
        self._pose_wc_prev = None
        self._reloc_vel = None
        self.tracker.error = best_err
        return True

    # ------------------------------------------------------------------
    # loop closure (deepfactors.cpp:246-280)
    # ------------------------------------------------------------------

    def _loop_add_keyframe(self, slot: int):
        """The keyframe's BoW row: from its reprojection keypoints when the
        map keeps them, else from a detection at level 0."""
        st = self.mapper.state
        if st.kp_desc.shape[1] > 0:
            self.loop_detector.add_keyframe(slot, st.kp_desc[slot],
                                            st.kp_valid[slot])
        else:
            f = det.detect(st.levels[0].img[slot],
                           det.DetectorConfig(max_keypoints=128))
            self.loop_detector.add_keyframe(slot, f.descriptor, f.valid)

    def _loop_closure(self, img_pyr, grad_pyr, probe: dict, cur_feat,
                      kf: int):
        """Local loop: a photometric link to the nearest keyframe outside
        the active window (deepfactors.cpp:248-261), from the probe's
        distances. Global loop (deepfactors.cpp:263-280), after the
        cooldown: BoW candidates from the probe's similarities, verified
        densely in one batch; a live target gets a pose prior and a
        reprojection link, an archived one a pose prior."""
        st = self.mapper.state
        win = set(self.mapper.kf_slots[-self.cfg.loop_active_window:])
        local, best_d = -1, self.cfg.loop_max_dist
        for s in self.mapper.kf_slots:
            if s in win or s == kf:
                continue
            if float(probe["d_full"][s]) < best_d:
                local, best_d = s, float(probe["d_full"][s])
        if local >= 0 and not self._link_exists(kf, local):
            self.mapper.enqueue_link(kf, local, photo=True)
            self.loop_links.append((kf, local))
            self.n_local_links += 1
        if (self.n_frames - self._last_loop_nframe
                <= self.cfg.loop_cooldown):
            return
        res = self.loop_detector.detect_loop(
            cur_feat.descriptor, cur_feat.valid, img_pyr, grad_pyr,
            self.pose_wc, st, self.mapper.kf_slots,
            sims_np=probe["sims"], next_kid=self.mapper._next_kid)
        if res.detected and res.archived_idx >= 0:
            arch = SE3(self._dev(res.arch_pose_w.q),
                       self._dev(res.arch_pose_w.t))
            if self._apply_loop_correction(res, kf, arch):
                self.loop_links.append((kf, ("arch", res.archived_idx)))
                self.n_archived_loops += 1
                self._last_loop_nframe = self.n_frames
        elif res.detected and res.slot != kf \
                and not self._link_exists(kf, res.slot):
            # live target: seed the correction from the verified relative
            # pose (a bare rep link cannot pull a large drift through the
            # fine level's redescending loss), then link for refinement
            tgt = se3m.index(self.mapper.state.pose, res.slot)
            if self._apply_loop_correction(res, kf, tgt):
                self.mapper.enqueue_link(kf, res.slot, photo=False, rep=True)
                self.loop_links.append((kf, res.slot))
                self.n_live_global_loops += 1
                self._last_loop_nframe = self.n_frames

    def _apply_loop_correction(self, res, kf: int, target_pose_w) -> bool:
        """Close a loop against a trusted pose (an archived keyframe's
        final pose, or a live target's current estimate): the verified
        relative pose gives a corrected world pose of the current frame;
        the world-frame correction is carried to the current keyframe and
        applied as a pose prior, and the keyframe's newest back-connection
        gets fresh photometric works, so that the window is re-optimised.
        False (nothing applied) when the correction is not finite."""
        # wc_corr = pose_target_w ∘ rel⁻¹
        wc_corr = se3m.mul(target_pose_w, se3m.inverse(res.pose_cand_cur))
        wc_est = SE3(self._dev(self.pose_wc.q), self._dev(self.pose_wc.t))
        delta = se3m.mul(wc_corr, se3m.inverse(wc_est))
        target = _host_pose(se3m.mul(delta, se3m.index(self.mapper.state.pose,
                                                      kf)))
        if not (np.all(np.isfinite(target.q))
                and np.all(np.isfinite(target.t))):
            return False
        self.mapper.add_loop_prior(kf, target, sigma=self.cfg.loop_sigma)
        others = [s for s in self.mapper.kf_slots if s != kf]
        if others:
            self.mapper._add_photo_pair(kf, others[-1], second_removes=True)
        return True

    def _link_exists(self, a: int, b: int) -> bool:
        for (_, (x, y)) in self.mapper.links_host:
            if (x == a and y == b) or (x == b and y == a):
                return True
        return False

    # ------------------------------------------------------------------
    # control (deepfactors.cpp:446-594)
    # ------------------------------------------------------------------

    def force_keyframe(self):
        """The next frame to retire becomes a keyframe."""
        self.force_keyframe_flag = True

    def force_frame(self):
        """The next frame to retire that builds no keyframe becomes a
        one-way frame."""
        self.force_frame_flag = True

    def prewarm(self):
        """First calls of every per-frame and per-event path, before the
        run, so that no frame of the run pays for them (the JAX
        ``prewarm`` compiles the same set). On the card: build every kernel
        (``ops/kernels/build.py``), create the cuBLAS and cuSOLVER handles
        and fill the caching allocator. Everything runs on throwaway
        objects of this configuration and a textured throwaway frame: a
        scratch mapper (``Mapper.prewarm``, with its own RANSAC generator)
        and a scratch loop detector. So the facade, its mapper and its loop
        detector stay bitwise as they were, and the run's RANSAC draws do
        not move. Covered: the frame step, the mapper's paths, a
        relocalisation against the pool (P = max_keyframes) and the archive
        (P = loop_archive_cap), and a loop verification padded to
        loop_max_candidates."""
        if self.device.type == "cuda":
            build.build_all()
        m = self.cfg.mapper
        L, K, dev = m.pyramid_levels, m.max_keyframes, self.device
        ys, xs = np.mgrid[0:m.height, 0:m.width].astype(np.float32)
        img = (0.5 + 0.3 * np.sin(xs / 7 + 1.5)
               * np.cos(ys / 5 + 0.45)).astype(np.float32)
        mp = self.mapper.prewarm(img)
        ld = None
        if self.loop_detector is not None:
            src = self.loop_detector
            ld = LoopDetector(src.cfg, self.cam, L, K, voc=src.voc,
                              archive_cap=src.A, device=dev)
        st = mp.state
        ident = se3m.identity(device=dev)
        out = self._frame_fn(
            self._upload_dtype(img),
            tuple(st.levels[l].img for l in range(L)),
            tuple(st.levels[l].dpt for l in range(L)),
            st.pose.q, st.pose.t, mp.frames.pose.q, mp.frames.pose.t,
            mp.kf_slots[-1] if mp.kf_slots else 0,
            ident.q, ident.t, ident.q, ident.t,
            *((ld.voc, ld.db, ld.db_valid) if ld is not None else ()))
        identK = se3m.identity((K,), device=dev)
        self._reloc_fn(tuple(st.levels[l].img for l in range(L)),
                       tuple(st.levels[l].dpt for l in range(L)),
                       out.img_pyr, out.grad_pyr, identK.q, identK.t)
        if ld is not None:
            if ld.A:
                self._arch_verify(out.img_pyr, out.grad_pyr, ld)
            # one candidate (slot 0), padded to loop_max_candidates
            sims = np.full(K + ld.A, -np.inf, np.float32)
            sims[0] = 1.0
            ld.detect_loop(None, None, out.img_pyr, out.grad_pyr,
                           SE3(np.array([1.0, 0, 0, 0], np.float32),
                               np.zeros(3, np.float32)),
                           st, [], sims_np=sims, next_kid=None)
        out.probe.cpu()
        if dev.type == "cuda":
            torch.cuda.synchronize()
