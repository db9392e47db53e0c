"""The Mapper: incremental MAP inference over keyframe poses and codes.

PyTorch port of the sequential subset of
``deepfactors_tpu/mapping/mapper.py`` (reference
sources/core/mapping/mapper.{h,cpp}, work_manager/df_work). The reference's
observable schedule is kept — the coarse-to-fine per-work level state
machine, per-level iteration budgets, descent on "no variables
relinearized" (df_work.cpp:99-195, mapper.cpp:517-539) — while each GN
iteration relinearises every active photometric factor in one
``sfm_gram_batch`` call per (level, target kind), assembles one dense
system and solves it with the code blocks Schur-eliminated.

Each GN iteration ends with one host read of the update norm (the early
exit on ``max_delta < relin_threshold``).

The map pools, frame store and marginal store are updated IN PLACE.

Not in this slice (each raises ``NotImplementedError``): keyframe eviction
when the window is full (``marginalize_keyframe``), reprojection and
geometric factors, depth priors, the native scheduler.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import configure_numerics
from ..geometry import se3 as se3m
from ..geometry import warping as wp
from ..geometry.camera import PinholeCamera, camera_pyramid
from ..geometry.se3 import SE3
from ..ops import dense_sfm as ds
from ..ops import image as ip
from ..solver import system as sysm
from ..tracking.tracker import TrackerConfig, track_c2f
from ..utils.timing import tic, toc
from . import factors as fct
from . import frames as fr
from . import map_state as ms
from . import marginal as mg
from .mapper_pools import FactorPool
from .scheduler import make_scheduler

Tensor = torch.Tensor

_EVICTION_SLICE = ("keyframe eviction (marginalize_keyframe, "
                   "solver/nearest_psd) comes with the next slice of the port")


class MapperConfig(NamedTuple):
    max_keyframes: int = 16
    max_frames: int = 2
    max_factors: int = 64          # photometric pool capacity
    code_size: int = 32
    height: int = 192
    width: int = 256
    pyramid_levels: int = 3
    pho_iters: tuple = (15, 15, 30)   # finest-first (deepfactors_options.h:83)
    huber_delta: float = 0.3
    avg_dpt: float = 2.0
    min_dpt: float = 0.0
    valid_border: int = 2
    code_prior: float = 1.0        # sigma (df_work.cpp:29-57)
    pose_prior: float = 0.3        # sigma
    relin_threshold: float = 0.05  # ISAM2 relinearizeThreshold equivalent
    connection_mode: str = "LASTN"  # FULL | LASTN | FIRST | LAST
    max_back_connections: int = 4
    lm_lambda: float = 1e-4        # GN damping
    # finest-level robust loss: 'tukey' redescends (zero weight beyond
    # tukey_c); coarse levels keep Huber
    fine_loss: str = "tukey"
    tukey_c: float = 0.10
    grad_mode: str = "interp"      # 'interp' | 'sampled'
    use_schur: bool = True
    use_photometric: bool = True
    # the remaining factor kinds come with later slices; the defaults match
    # the JAX package, so a configuration must switch them off explicitly
    use_reprojection: bool = True
    use_geometric: bool = False
    use_depth_prior: bool = False
    use_native_scheduler: bool = False


def _check_supported(cfg: MapperConfig):
    for flag, what in (("use_reprojection", "reprojection factors"),
                       ("use_geometric", "sparse geometric factors"),
                       ("use_depth_prior", "depth-prior factors")):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{what} ({flag}=True) come with a later slice of the port; "
                f"set {flag}=False")


class Mapper:
    def __init__(self, cfg: MapperConfig, cam: PinholeCamera, decoder=None,
                 device="cuda"):
        assert len(cfg.pho_iters) == cfg.pyramid_levels
        _check_supported(cfg)
        configure_numerics()
        self.cfg = cfg
        self.cam = cam
        self.decoder = decoder
        self.device = torch.device(device)
        self.cams = camera_pyramid(cam, cfg.pyramid_levels)
        self.params = ds.SfmParams(huber_delta=cfg.huber_delta,
                                   avg_dpt=cfg.avg_dpt, min_dpt=cfg.min_dpt,
                                   valid_border=cfg.valid_border)
        self.reset()

    def reset(self):
        cfg, dev = self.cfg, self.device
        self.state = ms.create(cfg.max_keyframes, cfg.code_size, cfg.height,
                               cfg.width, cfg.pyramid_levels, device=dev)
        self.frames = fr.create(cfg.max_frames, cfg.height, cfg.width,
                                cfg.pyramid_levels, device=dev)
        self.sched = make_scheduler(cfg)
        self.marginals = mg.create(cfg.max_keyframes, cfg.code_size,
                                   device=dev)
        self.kf_slots: list[int] = []      # insertion order of live slots
        self.frame_slots: list[int] = []
        self.kf_ids: dict[int, int] = {}   # id -> slot
        self._next_kid = 0
        self._anchor_pose: SE3 = se3m.identity(device=dev)
        self.last_max_delta = float("inf")
        self.frame_active_host = np.zeros(cfg.max_frames, bool)
        self.frame_marg_host = np.zeros(cfg.max_frames, bool)

    # -- views -------------------------------------------------------------

    @property
    def pool(self):
        return self.sched.photo_pool

    @property
    def work(self):
        return self.sched.wm

    def has_work(self) -> bool:
        return self.sched.has_work()

    def keyframe_poses(self) -> SE3:
        return self.state.pose

    def keyframe_codes(self) -> Tensor:
        return self.state.code

    # -- slots ---------------------------------------------------------------

    def _alloc_kf_slot(self) -> int:
        for s in range(self.cfg.max_keyframes):
            if s not in self.kf_slots:
                return s
        raise NotImplementedError(
            f"the keyframe window is full ({self.cfg.max_keyframes}): "
            + _EVICTION_SLICE)

    def marginalize_keyframe(self, victim: int) -> int:
        raise NotImplementedError(_EVICTION_SLICE)

    def _alloc_frame_slot(self) -> int:
        for s in range(self.cfg.max_frames):
            if s not in self.frame_slots:
                return s
        return self.frame_slots.pop(0)   # the oldest is marginalised already

    # -- keyframe construction ------------------------------------------------

    def _pyramids(self, img):
        im = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        img_pyr = tuple(ip.build_pyramid(im, self.cfg.pyramid_levels))
        return img_pyr, tuple(ip.build_gradient_pyramid(img_pyr))

    def _gate_error(self, prx, pose: SE3, img, gs: int):
        """Level-0 photometric error of warping the new keyframe (at depth
        from ``prx``) into keyframe ``gs``: the predicted-code gate."""
        cfg = self.cfg
        lvl0 = self.state.levels[0]
        dpt = cfg.avg_dpt / torch.clamp(prx, min=1e-4) - cfg.avg_dpt
        r = ds.sfm_evaluate_error(
            pose, se3m.index(self.state.pose, gs), self.cam, img,
            lvl0.img[gs], dpt, torch.zeros_like(dpt), lvl0.grad[gs],
            self.params)
        return torch.where(r.inliers > 0,
                           r.residual / torch.clamp(r.inliers, min=1.0),
                           torch.full_like(r.residual, float("inf")))

    def add_keyframe_to_map(self, img, pose: SE3, code=None,
                            pyramids_in=None) -> int:
        """Build and insert a keyframe (Mapper::BuildKeyframe,
        mapper.cpp:919-1007): decoder forward, predicted-code fold behind
        its photometric gate, pool write. ``pyramids_in`` optionally carries
        (img_pyr, grad_pyr) already on the device."""
        tic("kf:build")
        cfg, dev = self.cfg, self.device
        CS = cfg.code_size
        img_pyr, grad_pyr = (pyramids_in if pyramids_in is not None
                             else self._pyramids(img))
        slot = self._alloc_kf_slot()
        pose = SE3(torch.as_tensor(pose.q, dtype=torch.float32, device=dev),
                   torch.as_tensor(pose.t, dtype=torch.float32, device=dev))
        with_code = code is not None
        if self.decoder is not None:
            out = self.decoder.raw_outputs_T(img_pyr[0])
            prx0, jac, stdev = out["prx0"], out["jac"], out["stdev"]
            if with_code:
                kf_code = torch.as_tensor(code, dtype=torch.float32, device=dev)
            else:
                # fold the predicted code into prx0 and re-zero: the zero-code
                # prior then anchors depth at the prediction. Gate: keep the
                # prediction only if it warps at least as well as the zero
                # code against the newest keyframe (absent at bootstrap).
                c = out["code_pred"]
                prx_pred = tuple(p + torch.einsum("chw,c->hw", j, c)
                                 for p, j in zip(prx0, jac))
                if self.kf_slots:
                    gs = self.kf_slots[-1]
                    e_pred = self._gate_error(prx_pred[0], pose, img_pyr[0], gs)
                    e_zero = self._gate_error(prx0[0], pose, img_pyr[0], gs)
                    use_pred = e_pred <= e_zero
                    prx0 = tuple(torch.where(use_pred, a, b)
                                 for a, b in zip(prx_pred, prx0))
                else:
                    prx0 = prx_pred
                kf_code = torch.zeros((CS,), device=dev)
        else:
            prx0 = tuple(torch.full_like(im, 0.5) for im in img_pyr)
            jac = tuple(torch.zeros((CS,) + im.shape, device=dev)
                        for im in img_pyr)
            stdev = tuple(torch.zeros_like(im) for im in img_pyr)
            kf_code = (torch.as_tensor(code, dtype=torch.float32, device=dev)
                       if with_code else torch.zeros((CS,), device=dev))
        ms.add_keyframe(self.state, slot, pose, kf_code, img_pyr, grad_pyr,
                        prx0, jac, stdev, cfg.avg_dpt)
        self.kf_slots.append(slot)
        self.kf_ids[self._next_kid] = slot
        self._next_kid += 1
        toc("kf:build")
        return slot

    # -- enqueue API (mapper.cpp:164-392) --------------------------------------

    def init_two_frames(self, img0, img1, pose0=None, pose1=None):
        """InitTwoFrames (mapper.cpp:164-189): both keyframes, connected both
        ways, optimised until the work queue drains. The second pose is
        seeded by a multi-hypothesis dense C2F alignment against the first
        keyframe's decoded depth (an identity start diverges beyond a
        ~10 deg / ~0.15 m baseline)."""
        self.reset()
        p0 = pose0 if pose0 is not None else se3m.identity(device=self.device)
        s0 = self.add_keyframe_to_map(img0, p0)
        self.update_map()
        if pose1 is None:
            L = self.cfg.pyramid_levels
            q, t = self.bootstrap_align(
                tuple(self.state.levels[l].img[s0] for l in range(L)),
                tuple(self.state.levels[l].dpt[s0] for l in range(L)),
                torch.as_tensor(np.asarray(img1, np.float32),
                                device=self.device))
            p1 = se3m.mul(p0, se3m.inverse(SE3(q, t)))
        else:
            p1 = pose1
        s1 = self.add_keyframe_to_map(img1, p1)
        self._anchor_pose = SE3(
            torch.as_tensor(p0.q, dtype=torch.float32, device=self.device),
            torch.as_tensor(p0.t, dtype=torch.float32, device=self.device))
        self._add_photo_pair(s0, s1)
        while self.has_work():
            self.mapping_run()
        return s0, s1

    def bootstrap_align(self, kf_imgs, kf_dpts, img1):
        """Bootstrap aligner (the JAX ``_bootstrap_align_fn``): 7 yaw
        hypotheses x full C2F dense SE(3) GN over pyramid_levels + 1 levels,
        best by error with an inlier floor of 0.25; identity when every
        hypothesis fails. Returns (q, t) of pose_ck (kf0 -> cam1)."""
        L4 = self.cfg.pyramid_levels + 1
        cams = camera_pyramid(self.cam, L4)
        tcfg = TrackerConfig(pyramid_levels=L4,
                             iterations_per_level=tuple([12] * (L4 - 1) + [20]),
                             huber_delta=self.cfg.huber_delta)
        kf4 = tuple(kf_imgs) + (ip.gaussian_blur_down(kf_imgs[-1]),)
        dp4 = tuple(kf_dpts) + (ip.gaussian_blur_down(kf_dpts[-1]),)
        im4 = tuple(ip.build_pyramid(img1, L4))
        gr4 = tuple(ip.build_gradient_pyramid(im4))
        dev = self.device
        qs, ts, sts = [], [], []
        for yaw in (0.0, 0.15, -0.15, 0.3, -0.3, 0.45, -0.45):
            q0 = se3m.so3_exp_quat(torch.tensor([0.0, yaw, 0.0], device=dev))
            q, t, st = track_c2f(tcfg, cams, SE3(q0, torch.zeros(3, device=dev)),
                                 kf4, dp4, im4, gr4)
            qs.append(q)
            ts.append(t)
            sts.append(st)
        qs, ts, st = torch.stack(qs), torch.stack(ts), torch.stack(sts)
        errs = torch.where(st[:, 0] > 0.25, st[:, 1],
                           torch.full_like(st[:, 1], float("inf")))
        b = torch.argmin(errs)
        ok = torch.isfinite(errs[b])
        ident = se3m.identity(device=dev)
        return (torch.where(ok, qs[b], ident.q), torch.where(ok, ts[b], ident.t))

    def enqueue_keyframe(self, img, pose_init: SE3, code=None,
                         pyramids_in=None) -> int:
        """EnqueueKeyframe (mapper.cpp:282-344): photometric works both ways
        to the back-connections."""
        if len(self.kf_slots) >= self.cfg.max_keyframes:
            raise NotImplementedError(
                f"the keyframe window is full ({self.cfg.max_keyframes}): "
                + _EVICTION_SLICE)
        conns = self._back_connections()
        slot = self.add_keyframe_to_map(img, pose_init, code,
                                        pyramids_in=pyramids_in)
        self.marginalize_frames()
        if self.cfg.use_photometric:
            for back in conns:
                self._add_photo_pair(slot, back, second_removes=True)
        return slot

    def enqueue_frame(self, img, pose_init: SE3, kf_slot: int,
                      pyramids=None) -> int:
        """EnqueueFrame (mapper.cpp:247-267): one-way frame as photometric
        target of the given keyframe."""
        self.marginalize_frames()
        img_pyr, grad_pyr = (pyramids if pyramids is not None
                             else self._pyramids(img))
        fslot = self._alloc_frame_slot()
        dev = self.device
        pose = SE3(torch.as_tensor(pose_init.q, dtype=torch.float32, device=dev),
                   torch.as_tensor(pose_init.t, dtype=torch.float32, device=dev))
        fr.add_frame(self.frames, fslot, pose, img_pyr, grad_pyr)
        self.frame_slots.append(fslot)
        self.frame_active_host[fslot] = True
        self.frame_marg_host[fslot] = False
        self.sched.add_photo(kf_slot, fslot, True, self.cfg.pho_iters)
        return fslot

    def _add_photo_pair(self, s0: int, s1: int, second_removes: bool = False):
        """Both-way photometric works (mapper.cpp:305-311); the second
        direction carries remove_after. A new work on an existing pair
        replaces the old persistent factor."""
        self.sched.add_photo(s0, s1, False, self.cfg.pho_iters, replace=True)
        second = self.sched.add_photo(s1, s0, False, self.cfg.pho_iters,
                                      remove_after=second_removes,
                                      replace=True)
        return second

    def _back_connections(self) -> list[int]:
        """BuildBackConnections (mapper.cpp:1011-1037) over live slots."""
        mode = self.cfg.connection_mode
        order = self.kf_slots
        if not order:
            return []
        if mode == "FULL":
            return list(reversed(order))
        if mode == "LASTN":
            return list(reversed(order[-self.cfg.max_back_connections:]))
        if mode == "FIRST":
            return [order[0]]
        return [order[-1]]

    # -- frame marginalisation --------------------------------------------------

    def _depth_pyramid(self):
        """Depth at the current codes per level (not written to the map)."""
        st = self.state
        return tuple(
            wp.prox_to_depth(torch.clamp(
                lvl.prx0 + torch.einsum("kchw,kc->khw", lvl.jac, st.code),
                min=1e-4), self.cfg.avg_dpt)
            for lvl in st.levels)

    def marginalize_frames(self):
        """MarginalizeFrames (mapper.cpp:395-436): fold each live frame's
        photometric information into a marginal prior over its keyframe
        (Schur elimination of the frame pose), then drop the frame's factors
        and variable."""
        victims = [s for s in range(self.cfg.max_frames)
                   if self.frame_active_host[s] and not self.frame_marg_host[s]]
        if not victims:
            return
        tic("kf:margfr")
        pool = self.sched.photo_pool
        E = self.cfg.max_frames
        kfs = np.zeros(E, np.int64)
        fss = np.zeros(E, np.int64)
        lvls = np.zeros(E, np.int64)
        act = np.zeros(E, bool)
        j = 0
        for s in victims:
            for i in range(self.cfg.max_factors):
                if (pool.active[i] and pool.dst_is_frame[i]
                        and pool.dst[i] == s and j < E):
                    kfs[j], fss[j] = int(pool.src[i]), s
                    lvls[j], act[j] = int(pool.level[i]), True
                    j += 1
        self._fold_frames(kfs, fss, lvls, act)
        for s in victims:
            self.frame_marg_host[s] = True
            self.frames.marginalized[s] = True
            self.sched.erase_frame(s)
        toc("kf:margfr")

    def _fold_frames(self, kfs, fss, lvls, act):
        """Linearise every live frame factor at its level, Schur-eliminate
        the frame pose, and accumulate the marginal priors (the JAX
        ``_fold_frames_fn``)."""
        cfg, dev = self.cfg, self.device
        E, CS = cfg.max_frames, cfg.code_size
        Df = 12 + CS
        dpts = self._depth_pyramid()
        kfs_d = torch.as_tensor(kfs, device=dev)
        fss_d = torch.as_tensor(np.clip(fss, 0, E - 1), device=dev)
        pose0 = ms.poses_of(self.state, kfs_d)
        pose1 = SE3(self.frames.pose.q[fss_d], self.frames.pose.t[fss_d])
        code0 = self.state.code[kfs_d]
        JtJ = torch.zeros((E, Df, Df), device=dev)
        Jtr = torch.zeros((E, Df), device=dev)
        for l in range(cfg.pyramid_levels):
            m = act & (lvls == l)
            if not m.any():
                continue
            lp, lloss = self._level_loss(l)
            lvl, flv = self.state.levels[l], self.frames.levels[l]
            gx, gy = fct._grad_planes(flv.grad, cfg.grad_mode)
            m_d = torch.as_tensor(m, device=dev)
            fb = fct.photometric_gram_pools(
                pose0, pose1, code0, kfs_d, fss_d, self.cams[l], lp, lvl.img,
                dpts[l], lvl.jac, flv.img, gx, gy, active=m_d,
                grad_mode=cfg.grad_mode, loss=lloss)
            JtJ = JtJ + torch.where(m_d[:, None, None], fb.JtJ,
                                    torch.zeros_like(fb.JtJ))
            Jtr = Jtr + torch.where(m_d[:, None], fb.Jtr,
                                    torch.zeros_like(fb.Jtr))
        Hm, bm = mg.schur_marginalize_frame(JtJ, Jtr, CS)
        for jj in np.nonzero(act)[0]:
            k = int(kfs[jj])
            mg.add_prior(self.marginals, k, Hm[jj], bm[jj],
                         se3m.index(self.state.pose, k), self.state.code[k])

    # -- the mapping iteration ---------------------------------------------------

    def _level_loss(self, level: int):
        """(params, loss): redescending fine_loss at level 0, Huber at the
        coarse levels."""
        if level == 0 and self.cfg.fine_loss != "huber":
            return self.params._replace(huber_delta=self.cfg.tukey_c), \
                self.cfg.fine_loss
        return self.params, "huber"

    def _frame_photo_batch(self, src, dst, level, active):
        """Photometric factors whose target is a one-way frame. Pool entries
        targeting keyframes carry dst >= F: clamp before indexing (those
        entries are masked out)."""
        F = self.cfg.max_frames
        lvl, flv = self.state.levels[level], self.frames.levels[level]
        dstc = torch.clamp(dst, 0, F - 1)
        pose1 = SE3(self.frames.pose.q[dstc], self.frames.pose.t[dstc])
        lp, lloss = self._level_loss(level)
        gx, gy = fct._grad_planes(flv.grad, self.cfg.grad_mode)
        return fct.photometric_gram_pools(
            ms.poses_of(self.state, src), pose1, self.state.code[src], src,
            dstc, self.cams[level], lp, lvl.img, lvl.prx0, lvl.jac, flv.img,
            gx, gy, active=active, grad_mode=self.cfg.grad_mode,
            depth_from_code=True, loss=lloss)

    def gn_iteration(self, pool_src, pool_dst, pool_isf, pool_level,
                     pool_active, levels_present, use_frames) -> Tensor:
        """One damped GN iteration over the whole window (the JAX
        ``gn_iteration``): linearise, assemble, add priors, mask, solve,
        retract. Depth comes from prx0 + jacᵀ·code inside the
        linearisation. Updates the map and frame poses; returns the max
        |update| over the live variables (device scalar)."""
        cfg, dev = self.cfg, self.device
        K, CS, F = cfg.max_keyframes, cfg.code_size, cfg.max_frames
        Dp, Dc = 6 * K, CS * K
        D = Dp + Dc + 6 * F
        st = self.state
        ar6 = torch.arange(6, device=dev)
        arCS = torch.arange(CS, device=dev)
        Hs, bs, idxs, acts = [], [], [], []
        for l in levels_present:
            at_l = pool_active & (pool_level == l)
            kk = at_l & ~pool_isf
            kfm = at_l & pool_isf
            lp, lloss = self._level_loss(l)
            batch = fct.photometric_batch(
                st, pool_src, pool_dst, l, self.cams[l], lp, active=kk,
                grad_mode=cfg.grad_mode, depth_from_code=True, loss=lloss)
            Hs.append(batch.JtJ)
            bs.append(batch.Jtr)
            idxs.append(sysm.factor_slot_indices(pool_src, pool_dst, K, CS))
            acts.append(kk)
            if F > 0 and use_frames:
                fb = self._frame_photo_batch(pool_src, pool_dst, l, kfm)
                idxs.append(torch.cat([
                    pool_src[:, None] * 6 + ar6,
                    Dp + Dc + torch.clamp(pool_dst, 0, F - 1)[:, None] * 6
                    + ar6,
                    Dp + pool_src[:, None] * CS + arCS], dim=-1))
                Hs.append(fb.JtJ)
                bs.append(fb.Jtr)
                acts.append(kfm)
        gsys = sysm.assemble(D, torch.cat(Hs), torch.cat(bs), torch.cat(idxs),
                             torch.cat(acts))

        # marginal priors from marginalised one-way frames
        mH, mg_ = mg.prior_terms(self.marginals, st.pose, st.code)
        slots = torch.arange(K, device=dev)
        midx = torch.cat([slots[:, None] * 6 + ar6,
                          Dp + slots[:, None] * CS + arCS], dim=-1)
        mgsys = sysm.assemble(D, mH, mg_, midx, self.marginals.active)
        gsys = sysm.GlobalSystem(gsys.H + mgsys.H, gsys.b + mgsys.b)

        # zero-code prior on every active code, pose prior pinning the anchor
        code_w = 1.0 / (cfg.code_prior ** 2)
        code_mask = st.active.repeat_interleave(CS).to(torch.float32)
        gsys = sysm.add_diagonal_prior(gsys, Dp + torch.arange(Dc, device=dev),
                                       code_w * code_mask, st.code.reshape(-1))
        anchor_slot = self.kf_slots[0] if self.kf_slots else 0
        pose_res = se3m.local(self._anchor_pose,
                              se3m.index(st.pose, anchor_slot))
        gsys = sysm.add_diagonal_prior(
            gsys, anchor_slot * 6 + ar6,
            torch.full((6,), 1.0 / (cfg.pose_prior ** 2), device=dev), pose_res)

        fr_live = self.frames.active & ~self.frames.marginalized
        vmask = torch.cat([st.active.repeat_interleave(6),
                           st.active.repeat_interleave(CS),
                           fr_live.repeat_interleave(6)])
        gsys = sysm.mask_inactive(gsys, vmask)
        if cfg.use_schur and D > 150:
            delta = sysm.solve_schur_codes(gsys, K, CS, cfg.lm_lambda)
        else:
            delta = sysm.solve_damped(gsys, cfg.lm_lambda)

        new_pose = se3m.retract(st.pose, delta[:Dp].reshape(K, 6))
        self.state = st._replace(pose=new_pose,
                                 code=st.code + delta[Dp:Dp + Dc].reshape(K, CS))
        if F > 0:
            fp = se3m.retract(self.frames.pose, delta[Dp + Dc:].reshape(F, 6))
            self.frames = self.frames._replace(pose=fp)
        return torch.max(torch.abs(delta * vmask.to(delta.dtype)))

    def _run(self, pool: FactorPool, levels_present, budget: int,
             use_frames: bool, eff_level=None):
        """Up to ``budget`` GN iterations, leaving early once the update norm
        drops below relin_threshold. Returns (iterations, last max delta)."""
        dev = self.device
        t = lambda a, dt=torch.long: torch.as_tensor(
            np.ascontiguousarray(a), device=dev).to(dt)
        src, dst = t(pool.src), t(pool.dst)
        isf, act = t(pool.dst_is_frame, torch.bool), t(pool.active, torch.bool)
        level = t(pool.level if eff_level is None else eff_level)
        it, delta = 0, float("inf")
        while it < budget and delta >= self.cfg.relin_threshold:
            delta = float(self.gn_iteration(src, dst, isf, level, act,
                                            levels_present, use_frames))
            it += 1
        return it, delta

    def run_segments(self, pool: FactorPool, descent, segments):
        """The whole coarse-to-fine descent (the JAX ``run_segments``): for
        each (level, budget) of ``segments``, up to ``budget`` GN iterations
        at that level, leaving early on convergence. Factors marked in
        ``descent`` (owned by the descending works) follow the segment
        level; persistent factors of finished works keep their own.
        Returns [(iterations, last max delta)] per segment."""
        use_frames = bool(np.any(pool.active & pool.dst_is_frame))
        return [self._run(pool, tuple(sorted({lvl, 0})), budget, use_frames,
                          np.where(descent, lvl, pool.level))
                for lvl, budget in segments]

    def _fused_segments(self):
        """The (level, budget) descent when all outstanding works share one
        schedule state, else None."""
        sig = self.sched.fused_sig()
        if sig is None:
            return None
        lvl, iters, orig = sig
        if lvl < 0:
            return None
        segs = [(lvl, iters[lvl] + 1)]
        for l in range(lvl - 1, -1, -1):
            segs.append((l, orig[l] + 1))
        return tuple(segs)

    def mapping_run(self):
        """Run mapping to the next schedule boundary. When every work shares
        one level state the whole coarse-to-fine descent runs here, segment
        by segment (the JAX ``run_segments``); otherwise one phase-wise
        ``mapping_step``. Drives the same Work state machine either way."""
        segs = self._fused_segments()
        if segs is None:
            tic("map:step")
            self.mapping_step()
            toc("map:step")
            return
        tic("map:segments")
        self.sched.bookkeeping()
        pool, descent = self._compact_pool(extra=self.sched.descent_slots())
        self.run_segments(pool, descent, segs)
        # every segment ran to completion (early exit skips iterations, never
        # a level), so the host schedule replay exhausts each budget
        for _, seg_budget in segs:
            self.sched.update(seg_budget, False)
            self.sched.bookkeeping()
        self.sched.update(0, False)  # sweep remove_after works
        toc("map:segments")

    def mapping_step(self):
        """One mapping phase: GN iterations until the next schedule boundary
        or convergence (a run of reference MappingSteps, mapper.cpp:449-552)."""
        if not self.sched.has_work():
            return
        self.sched.bookkeeping()
        budget = self.sched.budget()
        pool = self._compact_pool()
        levels_present = tuple(sorted({int(l) for l, a in
                                       zip(pool.level, pool.active) if a}))
        if not levels_present:
            self.sched.tick_empty()
            return
        iters, self.last_max_delta = self._run(
            pool, levels_present, budget,
            bool(np.any(pool.active & pool.dst_is_frame)))
        self.sched.update(max(1, iters),
                          self.last_max_delta < self.cfg.relin_threshold)

    def _compact_pool(self, extra=None):
        """Active photo factors compacted into a bucket-sized prefix
        ({8, pow2(max/2), max_factors}); ``extra`` is compacted with the same
        permutation and returned alongside when given."""
        pool = self.pool
        act_idx = np.nonzero(pool.active)[0]
        n = max(1, len(act_idx))
        P = next(b for b in self._pool_buckets() if b >= n)
        sel = np.zeros(P, np.int64)
        sel[:len(act_idx)] = act_idx
        out = FactorPool(src=pool.src[sel].astype(np.int32),
                         dst=pool.dst[sel].astype(np.int32),
                         dst_is_frame=pool.dst_is_frame[sel],
                         level=pool.level[sel].astype(np.int32),
                         active=np.arange(P) < len(act_idx))
        if extra is not None:
            return out, extra[sel]
        return out

    def _pool_buckets(self):
        mf = self.cfg.max_factors
        b = {min(8, mf), mf}
        half = 1
        while half < mf // 2:
            half *= 2
        if 8 < half < mf:
            b.add(half)
        return sorted(b)

    def update_map(self):
        """Re-materialise the depth maps after optimisation (UpdateMap,
        mapper.cpp:859-899)."""
        ms.update_depth_all(self.state, self.cfg.avg_dpt)
