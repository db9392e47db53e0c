"""The DeepFactors system facade: the per-frame SLAM pipeline.

PyTorch port of the sequential subset of ``deepfactors_tpu/system.py``
(reference sources/core/deepfactors.{h,cpp}). Per frame (ProcessFrame,
deepfactors.cpp:220-366):

  preprocess -> keyframe selection -> frame step (pyramids + C2F tracking +
  decision probe, one host read) -> CheckTrackingLost
  -> NewKeyframeRequired? EnqueueKeyframe : NewFrameRequired? EnqueueFrame
  -> mapping until no work (or one run if interleave_mapping)

A run may outlive its keyframe window: the mapper evicts the oldest
keyframe that the facade does not protect (the tracker's keyframe and the
two newest), and the facade observes each eviction through the mapper's
``evict_callback``.

Sequential only (``pipeline_depth=0``). Loop closure, relocalisation,
pipelining and the I/O drivers come with later slices: a configuration or
a run that needs them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import configure_numerics
from . import frame_step as fs
from .geometry import se3 as se3m
from .geometry.camera import PinholeCamera
from .geometry.se3 import SE3
from .mapping.mapper import Mapper, MapperConfig
from .tracking.tracker import CameraTracker, TrackerConfig
from .utils.timing import tic, toc


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
    # loop closure comes with a later slice; the default matches the JAX
    # package, so a configuration must switch it off explicitly
    loop_closure: bool = True
    interleave_mapping: bool = False
    pipeline_depth: int = 0               # only 0 (sequential) in this slice


class Stats(NamedTuple):
    inliers: float
    tracker_error: float
    distance: float


def _host_pose(pose: SE3) -> SE3:
    return SE3(pose.q.detach().cpu().numpy(), pose.t.detach().cpu().numpy())


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
                 device="cuda"):
        if cfg.loop_closure:
            raise NotImplementedError(
                "loop closure comes with a later slice of the port; set "
                "SystemConfig.loop_closure=False")
        if cfg.pipeline_depth != 0:
            raise NotImplementedError(
                "pipelined mode (pipeline_depth > 0) comes with a later slice "
                "of the port; use pipeline_depth=0")
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
        self._frame_fn = fs.build_frame_fn(self.tracker.cfg, cam,
                                           m.pyramid_levels, with_loop=False)
        self._probe_off, _ = fs.probe_layout(m.max_keyframes, m.max_frames)
        self.reset()

    def reset(self):
        self.mapper.reset()
        self.tracker.reset()
        self.bootstrapped = False
        self.tracking_lost = False
        self.curr_kf: Optional[int] = None
        self.pose_wc = SE3(np.array([1.0, 0, 0, 0], np.float32),
                           np.zeros(3, np.float32))
        self.stats = Stats(0.0, float("inf"), 0.0)
        self.trajectory: list = []   # (timestamp, SE3 pose_wc) host numpy
        # previous frame's probe distances (CLOSEST keyframe selection)
        self._last_kf_dists: Optional[np.ndarray] = None
        # previous frame's world pose: constant-velocity tracking init
        self._pose_wc_prev: Optional[SE3] = None
        self._last_tracked_nframe = 0
        self.n_frames = 0
        self.n_lost_frames = 0
        self.n_evictions = 0

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

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
        self.bootstrapped = True
        self.tracking_lost = False
        rel = se3m.mul(se3m.inverse(se3m.index(pose, s0)),
                       se3m.index(pose, s1))
        g = max(1, int(frame_gap))
        vel = SE3(se3m.so3_exp_quat(se3m.so3_log(rel.q) / g), rel.t / g)
        p2 = se3m.mul(SE3(self._dev(self.pose_wc.q), self._dev(self.pose_wc.t)),
                      se3m.inverse(vel))
        self._pose_wc_prev = _host_pose(p2)
        self._last_tracked_nframe = self.n_frames
        toc("bootstrap")

    # ------------------------------------------------------------------
    # per-frame pipeline (deepfactors.cpp:220-366)
    # ------------------------------------------------------------------

    def process_frame(self, timestamp: float, img) -> None:
        """ProcessFrame (deepfactors.cpp:220-366)."""
        if not self.bootstrapped:
            raise RuntimeError(
                "Calling ProcessFrame before system is bootstrapped!")
        tic("preprocess")
        img = self.preprocess_image(img)
        toc("preprocess")
        self.n_frames += 1
        nframe = self.n_frames
        if self.tracking_lost:
            raise NotImplementedError(
                "tracking was lost: relocalisation (DeepFactors._relocalize) "
                "comes with the loop-closure slice of the port")
        newkf = self._select_keyframe()
        if newkf != self.curr_kf:
            self._set_current_kf(newkf)
        tic("frame step")
        out = self._dispatch_frame(img)
        probe, new_pose_wc = self._parse_probe(out.probe.cpu().numpy())
        toc("frame step")
        self._decide(timestamp, nframe, img, out, probe, new_pose_wc,
                     self.curr_kf)

    def _dispatch_frame(self, img):
        """Run the frame step with the constant-velocity prediction seeded
        from the host poses."""
        st = self.mapper.state
        fsd = self.mapper.frames
        L = self.cfg.mapper.pyramid_levels
        prev2 = self._pose_wc_prev if self._pose_wc_prev is not None \
            else self.pose_wc
        return self._frame_fn(
            img,
            tuple(st.levels[l].img for l in range(L)),
            tuple(st.levels[l].dpt for l in range(L)),
            st.pose.q, st.pose.t, fsd.pose.q, fsd.pose.t, self.curr_kf,
            self._dev(self.pose_wc.q), self._dev(self.pose_wc.t),
            self._dev(prev2.q), self._dev(prev2.t))

    def _decide(self, timestamp, nframe, img, out, probe, new_pose_wc,
                kf: int) -> None:
        """Post-tracking decisions for one frame: lost check, CV chain
        bookkeeping, keyframe/frame policies, mapping. ``kf`` is the
        keyframe the frame was tracked against."""
        self.tracker.inliers = probe["inliers"]
        self.tracker.error = probe["error"]
        self._last_kf_dists = probe["d_full"]
        dist = float(probe["d_full"][kf])
        self.tracking_lost = self._check_tracking_lost(probe, kf, dist)
        if self.tracking_lost:
            self._pose_wc_prev = None
            self.n_lost_frames += 1
            return
        self._pose_wc_prev = self.pose_wc
        self.pose_wc = new_pose_wc
        self._last_tracked_nframe = nframe
        self.trajectory.append((timestamp, new_pose_wc))

        if self._new_keyframe_required(probe, kf):
            tic("enqueue keyframe")
            slot = self.mapper.enqueue_keyframe(
                img, self.pose_wc, pyramids_in=(out.img_pyr, out.grad_pyr))
            self._set_current_kf(slot)
            # the new keyframe sits at the camera pose: closest by
            # construction (the cached distances predate it)
            self._last_kf_dists = np.array(self._last_kf_dists, copy=True)
            self._last_kf_dists[slot] = 0.0
            # refine the fresh keyframe now: tracking the next frame against
            # unrefined predicted depth can diverge
            while self.mapper.has_work():
                self.mapper.mapping_run()
            self.mapper.update_map()
            toc("enqueue keyframe")
            return

        if self._new_frame_required(probe, kf):
            self.mapper.enqueue_frame(img, self.pose_wc, kf,
                                      pyramids=(out.img_pyr, out.grad_pyr))

        self.stats = Stats(inliers=probe["inliers"],
                           tracker_error=probe["error"], distance=dist)

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
        """The mapper's ``evict_callback``: the place where the loop
        detector moves an evicted keyframe's data to its archive, once loop
        closure is ported. Counts the evictions."""
        self.n_evictions += 1

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
        mode = self.cfg.keyframe_mode
        if mode == "NEVER":
            return False
        inliers = probe["inliers"]
        distance = float(probe["d_full"][self.curr_kf if kf is None else kf])
        if mode == "AUTO":
            return (inliers < self.cfg.inlier_threshold
                    or distance > self.cfg.dist_threshold)
        delta = distance * 5 + probe["rot"] * 3
        return (delta > self.cfg.combined_threshold
                or inliers < self.cfg.inlier_threshold)

    def _new_frame_required(self, probe: dict, kf: int = None) -> bool:
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
