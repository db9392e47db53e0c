"""Loop detector: local (pose distance) and global (BoW retrieval with dense
geometric verification) loops, over live keyframes and an archive of
evicted ones.

PyTorch port of ``deepfactors_tpu/loop/loop_detector.py`` (reference
sources/core/system/loop_detector.cpp):
  - DetectLocalLoop (:190-224): the nearest keyframe OUTSIDE the most
    recent ``active_window`` by the weighted pose distance
    (warping.h:139-147).
  - DetectLoop (:96-185): a BoW query over the keyframes' descriptors keeps
    the top candidates above min_similarity outside the active window, then
    verifies them by dense SE(3) tracking of the current frame against
    every candidate AT ONCE (the reference tracks them one by one,
    loop_detector.cpp:149-168), and accepts the best verified candidate
    with an inlier share above min_inliers and a translation under
    max_dist.

The batched verification (``verify_batch``) is coarse-to-fine Gauss-Newton
over C candidates: each iteration is ONE ``ops/kernels/sfm_gram.
se3_gram_batch`` call with the candidate axis as its factor axis (src =
arange(C) into the gathered candidate pools, dst = 0 into the current
frame), then one batched 6x6 solve and retract. The packed [C, 9] result
(q | t | inlier share | error) is read to the host once. On CPU tensors the
kernel's plain twin computes the same Gram.

The database keeps the LIVE keyframe slots (rows [0, K)) and an ARCHIVE of
evicted keyframes (rows [K, K + archive_cap)): the archive holds each
evicted keyframe's BoW row, level-0 image and depth and final pose, so a
revisit can still close a loop after its target left the window.
``loop_detector_from_numpy`` / ``loop_detector_to_numpy`` carry this state
across from and to host arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera, camera_pyramid
from ..geometry.se3 import SE3
from ..ops import dense_sfm as ds
from ..ops import image as ip
from ..ops.kernels import sfm_gram as sg
from . import vocabulary as vb

Tensor = torch.Tensor


class LoopConfig(NamedTuple):
    max_dist: float = 0.5          # loop_max_dist
    active_window: int = 10        # loop_active_window
    min_similarity: float = 0.35   # loop_min_similarity
    max_candidates: int = 10       # loop_max_candidates
    min_inliers: float = 0.5       # inlier acceptance (loop_detector.cpp:160)
    iters_per_level: tuple = (10, 5, 4)
    huber_delta: float = 0.3
    grad_mode: str = "interp"      # see TrackerConfig.grad_mode


class LoopResult(NamedTuple):
    detected: bool
    slot: int                      # matched keyframe slot (-1 if none)
    pose_cand_cur: Optional[SE3]   # verified pose candidate -> current
    archived_idx: int = -1         # archive index of an evicted match
    arch_pose_w: Optional[SE3] = None  # its world pose (host numpy)


def _on(pose: SE3, device) -> SE3:
    """A pose of host arrays or tensors as float32 tensors on ``device``."""
    return SE3(torch.as_tensor(pose.q, dtype=torch.float32, device=device),
               torch.as_tensor(pose.t, dtype=torch.float32, device=device))


def verify_batch(cfg: LoopConfig, cams, kf_imgs, kf_dpts, cur_imgs,
                 cur_grads, pq: Tensor, pt: Tensor) -> Tensor:
    """Dense C2F tracking of the current frame (per-level [h, w] images and
    [h, w, 2] gradients) against C candidates (per-level [C, h, w] image
    and depth pools) from the initial poses candidate -> current (pq [C,
    4], pt [C, 3]). Returns the packed [C, 9] (q | t | inl | err) on the
    device: inl is the finest level's valid share, err its residual per
    valid pixel (inf where none is valid)."""
    C = pq.shape[0]
    dev = pq.device
    q, t = pq, pt
    inl = torch.zeros((C,), device=dev)
    err = torch.full((C,), float("inf"), device=dev)
    src = torch.arange(C, dtype=torch.int32, device=dev)
    dstz = torch.zeros((C,), dtype=torch.int32, device=dev)
    for level in reversed(range(len(cams))):
        H, W = cur_imgs[level].shape
        area = float(H * W)
        img1 = cur_imgs[level][None]
        gxy = (None, None)
        if cfg.grad_mode == "sampled":
            gxy = (cur_grads[level][..., 0][None].contiguous(),
                   cur_grads[level][..., 1][None].contiguous())
        for _ in range(cfg.iters_per_level[level]):
            kp = sg.make_sfm_params(SE3(q, t), cams[level], 1, 0.0,
                                    cfg.huber_delta, 2.0)
            G = sg.se3_gram_batch(kp, src, dstz, kf_imgs[level],
                                  kf_dpts[level], img1, *gxy,
                                  grad_mode=cfg.grad_mode)
            JtJ = 0.5 * (G[:, :6, :6] + G[:, :6, :6].transpose(-1, -2))
            Jtr, resid, inliers = G[:, :6, 6], G[:, 6, 6], G[:, 7, 7]
            newp = ds.se3_solve_and_update(JtJ, Jtr, SE3(q, t), damping=1e-8)
            q, t = newp.q, newp.t
            inl = inliers / area
            err = torch.where(inliers > 0,
                              resid / torch.clamp(inliers, min=1.0),
                              torch.full_like(resid, float("inf")))
    # ONE packed output: the caller reads one array
    return torch.cat([q, t, inl[:, None], err[:, None]], dim=-1)


def _make_verify_fn(cfg: LoopConfig, cam: PinholeCamera, levels: int):
    """``verify_batch`` bound to a configuration and camera pyramid:
    fn(kf_imgs, kf_dpts, cur_imgs, cur_grads, pq, pt) -> [C, 9]."""
    cams = camera_pyramid(cam, levels)

    def verify(kf_imgs, kf_dpts, cur_imgs, cur_grads, pq, pt):
        return verify_batch(cfg, cams, tuple(kf_imgs), tuple(kf_dpts),
                            tuple(cur_imgs), tuple(cur_grads), pq, pt)

    return verify


def unpack_verify(v):
    """Split the packed verify output [C, 9] -> (q, t, inl, err)."""
    return v[:, 0:4], v[:, 4:7], v[:, 7], v[:, 8]


class LoopDetector:
    """Stateful facade over the map's BoW database and the archive of
    evicted keyframes, on ``device``. Without ``voc`` it loads the shipped
    vocabulary (the JAX package's detector draws a random one).

    An archived keyframe keeps its BoW row, level-0 image and depth (the
    pyramids are rebuilt at verification) and its final pose; an accepted
    archived loop becomes a pose prior on the live window
    (``Mapper.add_loop_prior``). The reference keeps every keyframe live in
    ISAM2 (loop_detector.cpp:96-185, deepfactors.cpp:263-280) and needs no
    archive; the fixed-capacity pools do."""

    def __init__(self, cfg: LoopConfig, cam: PinholeCamera, levels: int,
                 max_keyframes: int, voc: Optional[vb.Vocabulary] = None,
                 archive_cap: int = 64, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        voc = voc if voc is not None else vb.default_vocabulary(
            device=self.device)
        self.voc = vb.Vocabulary(voc.words.to(self.device),
                                 voc.idf.to(self.device))
        self.K = max_keyframes
        self.A = archive_cap
        self.levels = levels
        self._verify = _make_verify_fn(cfg, cam, levels)
        self._H, self._W = int(cam.height), int(cam.width)
        self.reset()

    def reset(self):
        """Clear the database and the archive."""
        dev, A = self.device, self.A
        V = self.voc.words.shape[0]
        self.db = torch.zeros((self.K + A, V), device=dev)
        self.db_valid = torch.zeros((self.K + A,), dtype=torch.bool,
                                    device=dev)
        self.arch_img = torch.zeros((A, self._H, self._W), device=dev)
        self.arch_dpt = torch.ones((A, self._H, self._W), device=dev)
        ident = se3m.identity((A,), device=dev)
        self.arch_q, self.arch_t = ident.q.clone(), ident.t.clone()
        self.arch_ids = np.full((A,), -1, np.int64)   # host: keyframe ids
        self._arch_next = 0                            # round-robin pointer

    def add_keyframe(self, slot: int, desc: Tensor, valid: Tensor):
        """AddKeyframe: insert the keyframe's BoW vector into the database."""
        self.db[slot] = vb.bow_vector(self.voc, desc, valid)
        self.db_valid[slot] = True

    def remove_keyframe(self, slot: int):
        self.db_valid[slot] = False

    def archive_keyframe(self, slot: int, kf_id: int, state) -> int:
        """Move an evicted keyframe's loop-closure data into the archive:
        BoW row, level-0 image and depth, final pose. Called from the
        facade's eviction callback BEFORE the slot is reused. Returns the
        archive index (round-robin overwrite), -1 without an archive."""
        if self.A == 0:
            self.remove_keyframe(slot)
            return -1
        a = self._arch_next
        self._arch_next = (self._arch_next + 1) % self.A
        K = self.K
        self.db[K + a] = self.db[slot]
        self.db_valid[K + a] = self.db_valid[slot]
        self.db_valid[slot] = False
        lvl0 = state.levels[0]
        self.arch_img[a] = lvl0.img[slot]
        self.arch_dpt[a] = lvl0.dpt[slot]
        self.arch_q[a] = state.pose.q[slot]
        self.arch_t[a] = state.pose.t[slot]
        self.arch_ids[a] = kf_id
        return a

    def detect_local_loop(self, pose_cur: SE3, map_poses: SE3,
                          active: np.ndarray, kf_order: list,
                          cur_kf_slot: int) -> int:
        """Nearest keyframe outside the active window by pose distance
        (loop_detector.cpp:190-224). Returns the slot or -1."""
        win = set(kf_order[-self.cfg.active_window:])
        dists = se3m.pose_distance(
            map_poses, _on(pose_cur, map_poses.q.device)).cpu().numpy()
        best, best_d = -1, np.inf
        for s in kf_order:
            if s in win or not active[s] or s == cur_kf_slot:
                continue
            if dists[s] < best_d:
                best, best_d = s, dists[s]
        if best >= 0 and best_d < self.cfg.max_dist:
            return best
        return -1

    def _gather_cands(self, state, live_sl, arch_sl, is_arch, pose_cur: SE3):
        """Level-0 image and depth and the world pose of every candidate,
        from the live pool or the archive, their C2F pyramids rebuilt by
        blur-down (an archived keyframe's per-level decoded depth is gone;
        the blur-down only drives the dense verification), and the
        tracking start candidate -> current."""
        lvl0 = state.levels[0]
        sel = is_arch[:, None, None]
        img0 = torch.where(sel, self.arch_img[arch_sl], lvl0.img[live_sl])
        dpt0 = torch.where(sel, self.arch_dpt[arch_sl], lvl0.dpt[live_sl])
        q = torch.where(is_arch[:, None], self.arch_q[arch_sl],
                        state.pose.q[live_sl])
        t = torch.where(is_arch[:, None], self.arch_t[arch_sl],
                        state.pose.t[live_sl])
        img_pyr = tuple(ip.build_pyramid(img0, self.levels))
        dpt_pyr = tuple(ip.build_pyramid(dpt0, self.levels))
        init = se3m.mul(se3m.inverse(pose_cur), SE3(q, t))
        return img_pyr, dpt_pyr, init.q, init.t, q, t

    def detect_loop(self, desc, desc_valid, cur_imgs, cur_grads,
                    pose_cur: SE3, state, kf_order: list,
                    sims_np: Optional[np.ndarray] = None,
                    next_kid: Optional[int] = None) -> LoopResult:
        """Global loop detection with batched dense verification over live
        keyframes and the archive.

        ``sims_np`` may carry the BoW similarities already computed (the
        frame step's probe holds them, length K + archive_cap); the active
        window (live recency, and the temporal guard on recently archived
        keyframes through ``next_kid``) is applied on the host either way.
        ``pose_cur`` is the current world pose (host arrays or tensors)."""
        win = set(kf_order[-self.cfg.active_window:])
        if sims_np is None:
            v = vb.bow_vector(self.voc, desc, desc_valid)
            sims_np = vb.similarity(v, self.db, self.db_valid).cpu().numpy()
        sims_np = np.array(sims_np, copy=True)
        for s in win:
            sims_np[s] = -np.inf
        if next_kid is not None:
            for a in range(self.A):
                if (self.arch_ids[a] >= 0 and
                        next_kid - self.arch_ids[a]
                        <= self.cfg.active_window):
                    sims_np[self.K + a] = -np.inf
        order = np.argsort(-sims_np)[: self.cfg.max_candidates]
        cands = [int(s) for s in order
                 if sims_np[s] >= self.cfg.min_similarity]
        if not cands:
            return LoopResult(False, -1, None)

        # pad the candidate batch to max_candidates (one launch shape per
        # call site): padded rows repeat candidate 0 and are ignored below
        C = self.cfg.max_candidates
        cands_padded = cands + [cands[0]] * (C - len(cands))
        dev = self.device
        is_arch = torch.as_tensor(
            np.asarray([s >= self.K for s in cands_padded]), device=dev)
        live_sl = torch.as_tensor(np.asarray(
            [s if s < self.K else 0 for s in cands_padded], np.int64),
            device=dev)
        arch_sl = torch.as_tensor(np.asarray(
            [s - self.K if s >= self.K else 0 for s in cands_padded],
            np.int64), device=dev)
        kf_imgs, kf_dpts, iq, it, cq, ct = self._gather_cands(
            state, live_sl, arch_sl, is_arch, _on(pose_cur, dev))
        # pose_ck convention: cur_from_kf = pose_cur^-1 * pose_kf
        packed = self._verify(kf_imgs, kf_dpts, tuple(cur_imgs),
                              tuple(cur_grads), iq, it)
        pk = packed.cpu().numpy()             # ONE device -> host read
        q, t, inl = pk[:, 0:4], pk[:, 4:7], pk[:, 7]
        tnorm = np.linalg.norm(t, axis=-1)
        best = -1
        best_inl = self.cfg.min_inliers
        for i in range(len(cands)):
            if inl[i] > best_inl and tnorm[i] < self.cfg.max_dist:
                best, best_inl = i, inl[i]
        if best < 0:
            return LoopResult(False, -1, None)
        rel = SE3(torch.as_tensor(q[best], device=dev),
                  torch.as_tensor(t[best], device=dev))
        if cands[best] >= self.K:
            a = cands[best] - self.K
            return LoopResult(True, -1, rel, archived_idx=a,
                              arch_pose_w=SE3(cq[best].cpu().numpy(),
                                              ct[best].cpu().numpy()))
        return LoopResult(True, cands[best], rel)


def loop_detector_from_numpy(ld: LoopDetector, db, db_valid, arch_img,
                             arch_dpt, arch_q, arch_t, arch_ids,
                             arch_next: int) -> LoopDetector:
    """Set a detector's database and archive from host arrays (e.g. the
    JAX detector's after ``np.asarray``), in place; returns ``ld``."""
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.array(a), device=ld.device).to(dt)
    ld.db, ld.db_valid = t(db), t(db_valid, torch.bool)
    ld.arch_img, ld.arch_dpt = t(arch_img), t(arch_dpt)
    ld.arch_q, ld.arch_t = t(arch_q), t(arch_t)
    ld.arch_ids = np.array(arch_ids, np.int64)
    ld._arch_next = int(arch_next)
    return ld


def loop_detector_to_numpy(ld) -> dict:
    """The database and archive of a detector as host arrays (the keyword
    arguments of ``loop_detector_from_numpy``); takes the port's detector
    or the JAX package's."""
    n = lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)
                   else np.array(a))
    return dict(db=n(ld.db), db_valid=n(ld.db_valid), arch_img=n(ld.arch_img),
                arch_dpt=n(ld.arch_dpt), arch_q=n(ld.arch_q),
                arch_t=n(ld.arch_t), arch_ids=np.array(ld.arch_ids),
                arch_next=int(ld._arch_next))
