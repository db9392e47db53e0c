"""The Mapper: incremental MAP inference over keyframe poses and codes.

PyTorch port of the sequential subset of
``deepfactors_tpu/mapping/mapper.py`` (reference
sources/core/mapping/mapper.{h,cpp}, work_manager/df_work). The reference's
observable schedule is kept — the coarse-to-fine per-work level state
machine, per-level iteration budgets, descent on "no variables
relinearized" (df_work.cpp:99-195, mapper.cpp:517-539) — while each GN
iteration relinearises every active photometric factor in one
``sfm_gram_batch`` call per (level, target kind), every live reprojection
factor in one batched ``ops/sparse_factors.reprojection_system`` call and
every live geometric factor in one batched ``geometric_system`` call,
assembles one dense system and solves it with the code blocks
Schur-eliminated (a dense Cholesky when geometric factors are on: they
couple the codes of two keyframes, so the code blocks are no longer block
diagonal).

Reprojection factors (on by default, as in the JAX package): every keyframe
is built with its keypoints (``features/detector.detect_pyramid``); a
keyframe event matches the new keyframe with each back-connection both
ways and prunes the matches by 8-point RANSAC, all directions at once
(``features/matching``), then reads the packed result to the host in one
copy. A direction with at least 8 surviving matches becomes a
reprojection work; its factor stays in the rep pool until one of its
keyframes is evicted. The GN iterations read a device copy of the live rep
pool that is uploaded again only when the pool changes. The RANSAC draws
come from ``ransac_draw`` (a ``torch.Generator`` seeded with 42 unless a
caller replaces it: the JAX package draws from its own PRNG).

Sparse geometric factors (``use_geometric``): a keyframe event adds one
geometric work per back-connection, as a child of the connection's
photometric work, with ``geo_npoints`` pixels of the new keyframe drawn
uniformly by ``geo_draw`` (default: the mapper's own host generator,
seeded 42); with ``geo_stochastic`` every live geometric work draws new
points at each bookkeeping. A geometric factor stays in the geo pool
until one of its keyframes is evicted, and reads the keyframes' decoded
depth and the depth gradient ``dpt_grad`` the map state wrote at the
target's build. Its device copy is cached with the rep pool's.

Depth priors (``use_depth_prior``): ``set_depth_prior`` ties a keyframe's
code to a depth map through the blur-down pyramid of that map
(``factors.depth_prior_batch`` in every GN iteration).

Each GN iteration ends with one host read of the update norm (the early
exit on ``max_delta < relin_threshold``).

The map pools, frame store and marginal store are updated IN PLACE.

A full keyframe window evicts: the oldest unprotected keyframe is
marginalised into priors on its neighbours (``marginalize_keyframe``), its
pose is archived and its slot reused. ``dump_state`` / ``save_graphs``
inspect the map; with ``verbose_errors`` every live keyframe-to-keyframe
factor is evaluated by ``sfm_error_batch``.

Loop closure adds factors through ``enqueue_link`` (a photometric,
reprojection or geometric link between two live keyframes) and
``add_loop_prior`` (an absolute pose prior in the marginal store).

``use_native_scheduler`` runs the work schedule on the native C++ backend
(``scheduler.NativeBackend``) in place of the Python one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import configure_numerics
from ..geometry import se3 as se3m
from ..geometry import warping as wp
from ..geometry.camera import PinholeCamera, camera_pyramid
from ..geometry.se3 import SE3
from ..features import detector as det
from ..features import matching as mt
from ..features.sampler import sample_uniform_pixels
from ..frame_step import to_device
from ..models.decoder import Decoder
from ..ops import dense_sfm as ds
from ..ops import image as ip
from ..ops import sparse_factors as sf
from ..ops.kernels import sfm_error as se
from ..ops.kernels import sfm_gram as sg
from ..solver import system as sysm
from ..solver.nearest_psd import nearest_psd
from ..tracking.tracker import TrackerConfig, track_c2f
from ..utils.timing import span
from . import factors as fct
from . import frames as fr
from . import map_state as ms
from . import marginal as mg
from .mapper_pools import FactorPool, GeoPool
from .scheduler import PyScheduler, make_scheduler

Tensor = torch.Tensor


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
    # reprojection factors (deepfactors_options.h:91-101), on by default
    # like the reference's shipped configuration (common.flags:18)
    use_reprojection: bool = True
    max_keypoints: int = 128       # detector capacity (rep_nfeatures)
    # rep factors persist until their keyframe is evicted: worst case
    # max_keyframes * 2 directions * max_back_connections live at once,
    # plus loop links. 0 = derive that worst case at Mapper construction
    # (an explicit value is honoured as it is)
    max_rep_factors: int = 0
    rep_max_dist: float = 30.0     # hamming threshold for match pruning
    rep_huber: float = 0.1
    rep_iters: int = 15
    rep_sigma: float = 1.0
    rep_ransac_maxiters: int = 128
    rep_ransac_threshold: float = 1e-4
    # sparse geometric factors (deepfactors_options.h:103-108); they stay
    # in the geo pool until a keyframe of theirs is evicted
    use_geometric: bool = False
    max_geo_factors: int = 16
    geo_npoints: int = 128
    geo_stochastic: bool = False
    geo_huber: float = 0.1
    geo_iters: int = 15
    # depth priors on keyframe codes (DepthPriorFactor,
    # depth_prior_factor.cpp:83-123)
    use_depth_prior: bool = False
    dpt_prior_sigma: float = 1.0
    # the C++ scheduler backend (native/scheduler.cpp, built at first use)
    use_native_scheduler: bool = False


def schur_eliminate_block(H: Tensor, g: Tensor, B: int, N: int):
    """Eliminate the leading B variables of the system (H [D, D], g [D]),
    D = (1 + N)·B, and return the N diagonal blocks of the complement with
    their gradients: (Hb [N, B, B] PSD-projected, gb [N, B]). Cross blocks
    between the N remaining variables are dropped.

    H is symmetrised first (scatter-add rounding can leave it asymmetric),
    the eliminated block is damped by 1e-6·I, and non-finite results are
    zeroed before the eigendecomposition: a non-finite block carries no
    usable information and ``eigh`` raises or returns rubbish on NaN."""
    H = 0.5 * (H + H.T)
    Hvv = H[:B, :B] + 1e-6 * torch.eye(B, dtype=H.dtype, device=H.device)
    Hnv = H[B:, :B]
    sol = torch.linalg.solve(Hvv, torch.cat([Hnv.T, g[:B, None]], dim=1))
    Hnn = H[B:, B:] - Hnv @ sol[:, :-1]
    gn = g[B:] - Hnv @ sol[:, -1]
    k = torch.arange(N, device=H.device)
    Hb = Hnn.reshape(N, B, N, B)[k, :, k, :]
    Hb = 0.5 * (Hb + Hb.transpose(-1, -2))
    gb = torch.where(torch.isfinite(gn), gn, torch.zeros_like(gn))
    return nearest_psd(Hb), gb.reshape(N, B)


class Mapper:
    def __init__(self, cfg: MapperConfig, cam: PinholeCamera, decoder=None,
                 device="cuda"):
        assert len(cfg.pho_iters) == cfg.pyramid_levels
        configure_numerics()
        if cfg.max_rep_factors <= 0:
            cfg = cfg._replace(max_rep_factors=(
                cfg.max_keyframes * 2 * cfg.max_back_connections + 16))
        self.cfg = cfg
        self.cam = cam
        self.decoder = decoder
        self.device = torch.device(device)
        self.cams = camera_pyramid(cam, cfg.pyramid_levels)
        self.params = ds.SfmParams(huber_delta=cfg.huber_delta,
                                   avg_dpt=cfg.avg_dpt, min_dpt=cfg.min_dpt,
                                   valid_border=cfg.valid_border)
        # observer of evictions, fn(slot, kf_id); survives reset()
        self.evict_callback: Optional[Callable[[int, int], None]] = None
        # RANSAC hypothesis draws, fn(valids [2n, M] bool, iterations) ->
        # indices [2n, I, 8], one call per keyframe event that matches;
        # survives reset() like the JAX mapper's key chain
        self._rng = torch.Generator(device=self.device).manual_seed(42)
        self.ransac_draw: Callable = self._draw_hypotheses
        # geometric sample points, fn(n, width, height) -> [n, 2] pixels,
        # one call per geometric work and per stochastic resample. The
        # points live in the host pool, so the default draws on the host
        # (no device read); survives reset() like ransac_draw
        self._geo_rng = torch.Generator().manual_seed(42)
        self.geo_draw: Callable = self._draw_points
        self.reset()

    def _draw_hypotheses(self, valids, iterations):
        """The default ``ransac_draw``: uniform draws from the mapper's own
        generator (a bound method, so that a copy of the mapper draws from
        its own copy)."""
        return mt.draw_hypotheses(valids, iterations, self._rng)

    def _draw_points(self, n, width, height):
        """The default ``geo_draw``: uniform pixels inside a border of 1
        from the mapper's own host generator."""
        return sample_uniform_pixels(n, width, height, 1, self._geo_rng)

    def reset(self):
        cfg, dev = self.cfg, self.device
        self.state = ms.create(
            cfg.max_keyframes, cfg.code_size, cfg.height, cfg.width,
            cfg.pyramid_levels, max_links=4 * cfg.max_factors,
            max_keypoints=cfg.max_keypoints if cfg.use_reprojection else 0,
            device=dev)
        self.frames = fr.create(cfg.max_frames, cfg.height, cfg.width,
                                cfg.pyramid_levels, device=dev)
        self.sched = make_scheduler(cfg)
        self.marginals = mg.create(cfg.max_keyframes, cfg.code_size,
                                   device=dev)
        self.kf_slots: list[int] = []      # insertion order of live slots
        self.frame_slots: list[int] = []
        self.kf_ids: dict[int, int] = {}   # id -> slot
        self._next_kid = 0
        self._link_free: list[int] = []    # recycled link-table slots
        self.n_links = 0
        self.links_host: list = []         # (link slot, (slot_a, slot_b))
        # keyframe eviction: slots the facade needs live (the tracker's
        # keyframe, the newest keyframes) are never evicted; evicted
        # keyframes leave their id and final pose in the archive
        self.protected_slots: set = set()
        self.archived: list[dict] = []
        self._anchor_pose: SE3 = se3m.identity(device=dev)
        self.last_max_delta = float("inf")
        self.frame_active_host = np.zeros(cfg.max_frames, bool)
        self.frame_marg_host = np.zeros(cfg.max_frames, bool)
        self.dprior = self._empty_dprior()
        self._repgeo_cache = None          # (pool version, device copies)
        # GN iterations that assembled reprojection (geometric) factors, and
        # the factor terms they assembled in all
        self.rep_stats = {"iterations": 0, "factor_terms": 0}
        self.geo_stats = {"iterations": 0, "factor_terms": 0}

    # -- views -------------------------------------------------------------

    @property
    def pool(self):
        return self.sched.photo_pool

    @property
    def rep_pool(self):
        return self.sched.rep_pool

    @property
    def geo_pool(self):
        return self.sched.geo_pool

    @property
    def work(self):
        return self.sched.wm

    def has_work(self) -> bool:
        return self.sched.has_work()

    def keyframe_poses(self) -> SE3:
        return self.state.pose

    def keyframe_codes(self) -> Tensor:
        return self.state.code

    # -- depth priors (DepthPriorFactor, depth_prior_factor.cpp) -------------

    def _empty_dprior(self):
        cfg = self.cfg
        return {"pyr": tuple(
                    torch.ones((cfg.max_keyframes, cfg.height >> l,
                                cfg.width >> l), device=self.device)
                    for l in range(cfg.pyramid_levels)),
                "active": torch.zeros((cfg.max_keyframes,), dtype=torch.bool,
                                      device=self.device)}

    def set_depth_prior(self, slot: int, dpt):
        """Tie keyframe ``slot``'s code to a depth map [H, W] (host array or
        tensor): its blur-down pyramid (depth_prior_factor.cpp:45-54) is
        written in place and the code-only prior joins every GN iteration
        (requires cfg.use_depth_prior)."""
        if not self.cfg.use_depth_prior:
            raise RuntimeError("set_depth_prior requires use_depth_prior")
        d = torch.as_tensor(np.asarray(dpt, np.float32), device=self.device)
        for p, lvl in zip(self.dprior["pyr"],
                          ip.build_pyramid(d, self.cfg.pyramid_levels)):
            p[slot] = lvl
        self.dprior["active"][slot] = True

    # -- slots ---------------------------------------------------------------

    def _alloc_kf_slot(self) -> int:
        for s in range(self.cfg.max_keyframes):
            if s not in self.kf_slots:
                return s
        # window full: marginalise the oldest unprotected keyframe to a
        # prior and reuse its slot
        return self.marginalize_keyframe(self._select_victim())

    def _select_victim(self) -> int:
        for s in self.kf_slots:
            if s not in self.protected_slots:
                return s
        raise RuntimeError(
            "keyframe capacity exceeded and every slot is protected — "
            "raise max_keyframes")

    def marginalize_keyframe(self, victim: int) -> int:
        """Evict keyframe ``victim``: JOINTLY eliminate its (pose, code)
        block from the sum of all factors touching it — photometric factors
        plus the victim's zero-code prior and its accumulated marginal
        prior — and hand the resulting marginal information to the
        surviving neighbours (the ``marginalizeLeaves`` equivalent,
        mapper.cpp:395-436). Archives the final pose and frees the slot and
        every factor, work and link touching it. Returns the slot.

        The joint elimination matters: eliminating a code block per factor
        WITHOUT the code prior inverts a near-singular Hessian (texture-poor
        code directions) and injects unbounded priors. Cross-neighbour
        information blocks are dropped (the marginal store is block-diagonal
        per keyframe)."""
        with span("kf.evict"):
            if victim not in self.kf_slots:
                raise ValueError(f"slot {victim} holds no live keyframe")
            self.marginalize_frames()   # frame factors reference keyframes
            facs, neighbors = self._victim_factors(victim)
            if facs:
                self._eliminate(victim, facs, neighbors)
            # archive the final pose before the slot is reused, as device
            # tensors: a host read here would stall every eviction; readers
            # (dump_state) copy at the end of a run. Clones, since the pools
            # are written in place.
            kid = next((k for k, v in self.kf_ids.items() if v == victim), -1)
            self.archived.append({"id": kid,
                                  "q": self.state.pose.q[victim].clone(),
                                  "t": self.state.pose.t[victim].clone()})
            self.sched.erase_keyframe(victim)
            for li, pair in list(self.links_host):
                if victim in pair:
                    self.links_host.remove((li, pair))
                    self._link_free.append(li)
                    ms.remove_link(self.state, li)
            was_anchor = self.kf_slots[0] == victim
            self.kf_slots.remove(victim)
            if kid >= 0:
                del self.kf_ids[kid]
            self.state.active[victim] = False
            mg.clear(self.marginals, victim)
            if was_anchor and self.kf_slots:
                # re-anchor the gauge prior on the new oldest keyframe at its
                # current estimate (gauge continuity)
                a = self.kf_slots[0]
                self._anchor_pose = SE3(self.state.pose.q[a].clone(),
                                        self.state.pose.t[a].clone())
            if self.evict_callback is not None:
                self.evict_callback(victim, kid)
        return victim

    def _victim_factors(self, victim: int):
        """The live keyframe-to-keyframe photometric factors touching
        ``victim``, as (src, dst, level), and its live neighbours in the
        order they first appear."""
        pool = self.sched.photo_pool
        facs, neighbors = [], []
        for i in range(self.cfg.max_factors):
            if not pool.active[i] or pool.dst_is_frame[i]:
                continue
            s, d = int(pool.src[i]), int(pool.dst[i])
            if victim not in (s, d):
                continue
            nb = d if s == victim else s
            if nb not in self.kf_slots:
                continue
            if nb not in neighbors:
                neighbors.append(nb)
            facs.append((s, d, int(pool.level[i])))
        return facs, neighbors

    def _eliminate(self, victim: int, facs, neighbors) -> None:
        """The device side of an eviction (the body of the JAX ``_evict_fn``):
        linearise every victim-touching photometric factor at its level,
        add the victim's zero-code prior and its own marginal prior
        transported to the current estimate, Schur-eliminate the victim
        block, PSD-project each neighbour's diagonal block and accumulate it
        into the marginal store. Exact sizes: no padding of factors or
        neighbours. No host read."""
        cfg, dev = self.cfg, self.device
        CS = cfg.code_size
        B = 6 + CS
        N = len(neighbors)
        D = (1 + N) * B
        base = lambda slot: (0 if slot == victim
                             else B * (1 + neighbors.index(slot)))
        P = len(facs)
        src = np.array([f[0] for f in facs], np.int64)
        dst = np.array([f[1] for f in facs], np.int64)
        lvls = np.array([f[2] for f in facs], np.int64)
        idx = np.zeros((P, 12 + CS), np.int64)
        for j, (s, d, _) in enumerate(facs):
            idx[j] = np.concatenate([base(s) + np.arange(6),
                                     base(d) + np.arange(6),
                                     base(s) + 6 + np.arange(CS)])
        src_d = torch.as_tensor(src, device=dev)
        dst_d = torch.as_tensor(dst, device=dev)
        idx_d = torch.as_tensor(idx, device=dev)
        st = self.state
        dpts = self._depth_pyramid()
        pose0, pose1 = ms.poses_of(st, src_d), ms.poses_of(st, dst_d)
        code0 = st.code[src_d]
        H = torch.zeros((D, D), device=dev)
        g = torch.zeros((D,), device=dev)
        for l in sorted(set(lvls.tolist())):
            at_l = torch.as_tensor(lvls == l, device=dev)
            lp, lloss = self._level_loss(l)
            lvl = st.levels[l]
            gx, gy = fct._grad_planes(lvl.grad, cfg.grad_mode)
            batch = fct.photometric_gram_pools(
                pose0, pose1, code0, src_d, dst_d, self.cams[l], lp, lvl.img,
                dpts[l], lvl.jac, lvl.img, gx, gy, active=at_l,
                grad_mode=cfg.grad_mode, loss=lloss)
            gs = sysm.assemble(D, batch.JtJ, batch.Jtr, idx_d, at_l)
            H = H + gs.H
            g = g + gs.b
        # the victim's zero-code prior (df_work.cpp:29-57): the victim owns
        # it, so its information is folded too, and it regularises the
        # eliminated code block
        w_c = 1.0 / cfg.code_prior ** 2
        code_v = st.code[victim]
        cd = torch.arange(6, B, device=dev)
        H[cd, cd] += w_c
        g[6:B] += w_c * code_v
        # the victim's own accumulated marginal prior (frames, earlier
        # evictions), transported to the current estimate
        mstore = self.marginals
        m_on = mstore.active[victim].to(torch.float32)
        anchor = SE3(mstore.anchor_q[victim], mstore.anchor_t[victim])
        r = torch.cat([se3m.local(anchor, se3m.index(st.pose, victim)),
                       code_v - mstore.anchor_c[victim]])
        mH = mstore.H[victim] * m_on
        H[:B, :B] += mH
        g[:B] += mH @ r + mstore.b[victim] * m_on
        Hb, gb = schur_eliminate_block(H, g, B, N)
        for j, nb in enumerate(neighbors):
            mg.add_prior(self.marginals, nb, Hb[j], gb[j],
                         se3m.index(st.pose, nb), st.code[nb])

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

    def _gate_errors(self, prxs, pose: SE3, img, gs: int) -> Tensor:
        """Level-0 photometric error per pixel of warping the new keyframe
        into keyframe ``gs`` under each depth hypothesis of ``prxs`` (the
        predicted-code gate): ONE ``sfm_error_batch`` call over the stacked
        hypotheses, inf where nothing warps into view. The evaluation uses
        border 1 and min_dpt 0, like ``ds.sfm_evaluate_error``."""
        cfg = self.cfg
        n = len(prxs)
        lvl0 = self.state.levels[0]
        dpt = torch.stack([cfg.avg_dpt / torch.clamp(p, min=1e-4) - cfg.avg_dpt
                           for p in prxs])
        pose_10 = se3m.relative_pose(se3m.index(self.state.pose, gs), pose)
        kp = sg.make_sfm_params(
            SE3(pose_10.q.expand(n, 4), pose_10.t.expand(n, 3)), self.cam,
            1, 0.0, cfg.huber_delta, cfg.avg_dpt)
        res, inl = se.sfm_error_batch(
            kp, torch.arange(n, dtype=torch.int32, device=self.device),
            torch.zeros(n, dtype=torch.int32, device=self.device),
            img.expand(n, -1, -1).contiguous(), dpt,
            lvl0.img[gs][None])
        return torch.where(inl > 0, res / torch.clamp(inl, min=1.0),
                           torch.full_like(res, float("inf")))

    def add_keyframe_to_map(self, img, pose: SE3, code=None,
                            pyramids_in=None, pyramids=None) -> int:
        """Build and insert a keyframe (Mapper::BuildKeyframe,
        mapper.cpp:919-1007): decoder forward, predicted-code fold behind
        its photometric gate, pool write. ``pyramids_in`` optionally carries
        (img_pyr, grad_pyr) already on the device; ``pyramids`` the whole
        keyframe as it is to be written, (img_pyr, grad_pyr, prx0_pyr,
        jac_pyr, stdev_pyr, code) with each jac level feature-major
        [CS, h, w] (the JAX mapper's ``pyramids``, in the port's layout):
        no decoder runs."""
        with span("kf.build"):
            cfg, dev = self.cfg, self.device
            CS = cfg.code_size
            if pyramids is not None:
                img_pyr, grad_pyr, prx0, jac, stdev, code = pyramids
                pyramids_in = (img_pyr, grad_pyr)
            img_pyr, grad_pyr = (pyramids_in if pyramids_in is not None
                                 else self._pyramids(img))
            slot = self._alloc_kf_slot()
            f32 = dict(dtype=torch.float32, device=dev)
            pose = SE3(torch.as_tensor(pose.q, **f32),
                       torch.as_tensor(pose.t, **f32))
            with_code = code is not None
            if pyramids is not None:
                kf_code = torch.as_tensor(code, **f32)
            elif self.decoder is not None:
                out = self.decoder.raw_outputs_T(img_pyr[0])
                prx0, jac, stdev = out["prx0"], out["jac"], out["stdev"]
                if with_code:
                    kf_code = torch.as_tensor(code, **f32)
                else:
                    # fold the predicted code into prx0 and re-zero: the
                    # zero-code prior then anchors depth at the prediction.
                    # Gate: keep the prediction only if it warps at least as
                    # well as the zero code against the newest keyframe
                    # (absent at bootstrap).
                    c = out["code_pred"]
                    prx_pred = tuple(p + torch.einsum("chw,c->hw", j, c)
                                     for p, j in zip(prx0, jac))
                    if self.kf_slots:
                        gs = self.kf_slots[-1]
                        e_pred, e_zero = self._gate_errors(
                            (prx_pred[0], prx0[0]), pose, img_pyr[0], gs)
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
                kf_code = (torch.as_tensor(code, **f32)
                           if with_code else torch.zeros((CS,), device=dev))
            features = self._detect(img_pyr) if cfg.use_reprojection else None
            ms.add_keyframe(self.state, slot, pose, kf_code, img_pyr, grad_pyr,
                            prx0, jac, stdev, cfg.avg_dpt, features=features)
            self.kf_slots.append(slot)
            self.kf_ids[self._next_kid] = slot
            self._next_kid += 1
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

    def init_one_frame(self, img, pose=None) -> int:
        """InitOneFrame (the JAX ``Mapper.init_one_frame``): one keyframe
        at ``pose`` (identity unless given), the gauge anchored on it."""
        self.reset()
        dev = self.device
        p = pose if pose is not None else se3m.identity(device=dev)
        s = self.add_keyframe_to_map(img, p)
        self._anchor_pose = SE3(
            torch.as_tensor(p.q, dtype=torch.float32, device=dev),
            torch.as_tensor(p.t, dtype=torch.float32, device=dev))
        self.mapping_step()
        return s

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

    def _detect(self, img_pyr) -> det.Features:
        """The keyframe's keypoints (scale-space detection over its image
        pyramid)."""
        with span("kf.detect"):
            f = det.detect_pyramid(
                img_pyr,
                det.DetectorConfig(max_keypoints=self.cfg.max_keypoints))
        return f

    def enqueue_keyframe(self, img, pose_init: SE3, code=None,
                         pyramids_in=None) -> int:
        """EnqueueKeyframe (mapper.cpp:282-344): photometric works both ways
        to the back-connections, reprojection works both ways and a
        geometric work (new keyframe -> connection, a child of the
        connection's last photometric work) when enabled. The draws come in
        the JAX mapper's order: the RANSAC draw of all connections, then
        one geometric sample per connection."""
        # evict BEFORE selecting back-connections so none references a slot
        # about to be marginalised
        if len(self.kf_slots) >= self.cfg.max_keyframes:
            self.marginalize_keyframe(self._select_victim())
        conns = self._back_connections()
        slot = self.add_keyframe_to_map(img, pose_init, code,
                                        pyramids_in=pyramids_in)
        self.marginalize_frames()
        finish_rep = None
        if self.cfg.use_reprojection:
            # all back-connections in one match + RANSAC pass; its host copy
            # is read after the photometric works are registered
            finish_rep = self._add_rep_pairs_async(
                [(slot, back) for back in conns])
        for back in conns:
            last_photo = None
            if self.cfg.use_photometric:
                last_photo = self._add_photo_pair(slot, back,
                                                  second_removes=True)
            if self.cfg.use_geometric:
                self.sched.add_geo(slot, back, self.cfg.geo_iters,
                                   self._sample_geo_points(),
                                   parent=last_photo)
        if finish_rep is not None:
            finish_rep()
        return slot

    def _sample_geo_points(self) -> np.ndarray:
        """[geo_npoints, 2] float32 host array of sample pixels from the
        ``geo_draw`` hook."""
        pts = self.geo_draw(self.cfg.geo_npoints, self.cfg.width,
                            self.cfg.height)
        if torch.is_tensor(pts):
            pts = pts.cpu().numpy()
        return np.asarray(pts, np.float32)

    def _rep_pairs(self, slot_pairs) -> Tensor:
        """Match + RANSAC for both directions of every keyframe pair, all at
        once: direction 2j is (a_j, b_j), 2j+1 is (b_j, a_j). Returns the
        packed [2n, M, 5] device array (kp0 | kp1 | surviving match)."""
        cfg, st = self.cfg, self.state
        dirs = [d for a, b in slot_pairs for d in ((a, b), (b, a))]
        A, B = torch.tensor(dirs, device=self.device).T
        m = mt.match(st.kp_desc[A], st.kp_valid[A], st.kp_desc[B],
                     st.kp_valid[B], max_dist=int(cfg.rep_max_dist))
        kp0 = st.kp_xy[A]
        kp1 = torch.gather(st.kp_xy[B], 1,
                           m.idx1.long()[..., None].expand(-1, -1, 2))
        idx = torch.as_tensor(
            self.ransac_draw(m.valid, cfg.rep_ransac_maxiters),
            device=self.device)
        inl = mt.prune_matches_eight_point(
            kp0, kp1, m.valid, self.cam, idx=idx,
            threshold=cfg.rep_ransac_threshold)
        return torch.cat([kp0, kp1, (m.valid & inl).to(torch.float32)[..., None]],
                         dim=-1)

    def _add_rep_pairs(self, slot_pairs):
        self._add_rep_pairs_async(slot_pairs)()

    def _add_rep_pairs_async(self, slot_pairs):
        """Both-way reprojection works with matching + RANSAC pruning at
        construction (reprojection_factor.cpp:54-69) for every pair of a
        keyframe event. The device work starts here; the returned finish()
        reads the packed result to the host (the event's one copy) and
        registers the works, skipping a direction with fewer than 8
        surviving matches (df_work.cpp:316-347)."""
        if not slot_pairs:
            return lambda: None
        with span("kf.rep_dispatch"):
            out = self._rep_pairs(slot_pairs)

        def finish():
            with span("kf.rep_finish"):
                packed = out.cpu().numpy()
                kp0s, kp1s = packed[..., 0:2], packed[..., 2:4]
                valids = packed[..., 4] > 0.5
                dirs = [d for a, b in slot_pairs for d in ((a, b), (b, a))]
                for d, (a, b) in enumerate(dirs):
                    if valids[d].sum() >= 8:
                        self.sched.add_rep(a, b, self.cfg.rep_iters, kp0s[d],
                                           kp1s[d], valids[d])

        return finish

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

    def enqueue_link(self, slot0: int, slot1: int, photo=True, rep=False,
                     geo=False):
        """EnqueueLink (mapper.cpp:347-392): loop-closure factors between
        two live keyframes (photometric for local loops, reprojection for
        global loops, deepfactors.cpp:248-280; a geometric work slot0 ->
        slot1 with ``geo`` when geometric factors are on). Live frames are
        marginalised first. A global loop (rep=True) without reprojection
        factors falls back to a photometric link, so that an accepted loop
        always adds a factor."""
        self.marginalize_frames()
        if rep and not self.cfg.use_reprojection:
            photo = True
        if photo:
            self._add_photo_pair(slot0, slot1, second_removes=True)
        if rep and self.cfg.use_reprojection:
            self._add_rep_pairs([(slot0, slot1)])
        if geo and self.cfg.use_geometric:
            self.sched.add_geo(slot0, slot1, self.cfg.geo_iters,
                               self._sample_geo_points())

    def add_loop_prior(self, slot: int, target_pose: SE3, sigma: float = 1.0):
        """A loop constraint as an absolute pose prior on live keyframe
        ``slot`` anchored at ``target_pose`` (host arrays or tensors), folded
        into the marginal-prior store so that every later GN iteration sees
        it: a 6x6 block of weight 1/sigma² on the pose, the code block zero
        (the loop says nothing about depth). The facade closes loops against
        archived keyframes (and seeds live ones) with it."""
        dev = self.device
        B = 6 + self.cfg.code_size
        H = torch.zeros((B, B), device=dev)
        H.diagonal()[:6] = 1.0 / (sigma * sigma)
        pose = SE3(torch.as_tensor(target_pose.q, dtype=torch.float32,
                                   device=dev),
                   torch.as_tensor(target_pose.t, dtype=torch.float32,
                                   device=dev))
        mg.add_prior(self.marginals, slot, H, torch.zeros((B,), device=dev),
                     pose, self.state.code[slot])

    def _add_photo_pair(self, s0: int, s1: int, second_removes: bool = False):
        """Both-way photometric works (mapper.cpp:305-311); the second
        direction carries remove_after. A new work on an existing pair
        replaces the old persistent factor."""
        self.sched.add_photo(s0, s1, False, self.cfg.pho_iters, replace=True)
        second = self.sched.add_photo(s1, s0, False, self.cfg.pho_iters,
                                      remove_after=second_removes,
                                      replace=True)
        if self._link_free:
            li = self._link_free.pop()
        else:
            li = self.n_links
            self.n_links += 1
        if li < self.state.link_active.shape[0]:
            ms.add_link(self.state, li, s0, s1)
        self.links_host.append((li, (s0, s1)))
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
        with span("kf.margfr"):
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
        for on, fn in ((cfg.use_reprojection, self._rep_assemble),
                       (cfg.use_geometric, self._geo_assemble)):
            sg_ = fn(D) if on else None
            if sg_ is not None:
                gsys = sysm.GlobalSystem(gsys.H + sg_.H, gsys.b + sg_.b)

        # marginal priors from marginalised one-way frames
        mH, mg_ = mg.prior_terms(self.marginals, st.pose, st.code)
        slots = torch.arange(K, device=dev)
        midx = torch.cat([slots[:, None] * 6 + ar6,
                          Dp + slots[:, None] * CS + arCS], dim=-1)
        mgsys = sysm.assemble(D, mH, mg_, midx, self.marginals.active)
        gsys = sysm.GlobalSystem(gsys.H + mgsys.H, gsys.b + mgsys.b)

        if cfg.use_depth_prior:
            dp = fct.depth_prior_batch(st, self.dprior["pyr"],
                                       cfg.dpt_prior_sigma, cfg.avg_dpt)
            dsys = sysm.assemble(D, dp.JtJ, dp.Jtr,
                                 Dp + slots[:, None] * CS + arCS,
                                 self.dprior["active"])
            gsys = sysm.GlobalSystem(gsys.H + dsys.H, gsys.b + dsys.b)

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
        # the Schur solve needs block-diagonal code blocks; a geometric
        # factor couples the codes of its two keyframes, so with geometric
        # factors on the solve is dense
        if cfg.use_schur and not cfg.use_geometric and D > 150:
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

    def _rep_geo_dev(self):
        """Device copies of the live reprojection and geometric factors
        (dicts of src, dst, the match data or the points, and active,
        compacted to the active pool slots; None for a pool with none
        live). Uploaded again only when the scheduler's ``repgeo_version``
        moved (every rep or geo pool mutation bumps it), not per GN
        iteration; the uploads are pinned and do not synchronise the
        stream."""
        ver = self.sched.repgeo_version
        if self._repgeo_cache is not None and self._repgeo_cache[0] == ver:
            return self._repgeo_cache[1]
        out = []
        for p, data in ((self.sched.rep_pool, ("kp0", "kp1", "mvalid")),
                        (self.sched.geo_pool, ("points",))):
            sel = np.nonzero(p.active)[0]
            if not len(sel):
                out.append(None)
                continue
            t = lambda a: to_device(a[sel], self.device)
            d = {k: t(getattr(p, k)) for k in data}
            d.update(src=t(p.src).long(), dst=t(p.dst).long(),
                     active=torch.ones(len(sel), dtype=torch.bool,
                                       device=self.device))
            out.append(d)
        self._repgeo_cache = (ver, tuple(out))
        return self._repgeo_cache[1]

    def _geo_assemble(self, D: int) -> Optional[sysm.GlobalSystem]:
        """The GN system [D] of every live geometric factor, linearised at
        level 0 in one batched call (sparse_geometric_factor.cpp:146-268),
        each laid out [pose0 | pose1 | code0 | code1]; None when no geo
        factor is live."""
        geo = self._rep_geo_dev()[1]
        if geo is None:
            return None
        st, cfg = self.state, self.cfg
        K, CS = cfg.max_keyframes, cfg.code_size
        lvl0 = st.levels[0]
        src, dst = geo["src"], geo["dst"]
        gsys = sf.geometric_system(
            ms.poses_of(st, src), ms.poses_of(st, dst), st.code[src],
            st.code[dst], self.cams[0], geo["points"], lvl0.prx0, lvl0.jac,
            lvl0.prx0, lvl0.jac, st.dpt_grad, huber_delta=cfg.geo_huber,
            avg_dpt=cfg.avg_dpt, src=src, dst=dst)
        self.geo_stats["iterations"] += 1
        self.geo_stats["factor_terms"] += int(src.shape[0])
        ar6 = torch.arange(6, device=self.device)
        arCS = torch.arange(CS, device=self.device)
        Dp = 6 * K
        idx = torch.cat([src[:, None] * 6 + ar6, dst[:, None] * 6 + ar6,
                         Dp + src[:, None] * CS + arCS,
                         Dp + dst[:, None] * CS + arCS], dim=-1)
        return sysm.assemble(D, gsys.JtJ, gsys.Jtr, idx, geo["active"])

    def _rep_assemble(self, D: int) -> Optional[sysm.GlobalSystem]:
        """The GN system [D] of every live reprojection factor, linearised
        at level 0 in one batched call (reprojection_factor.cpp:159-269),
        each system laid out (pose0, pose1, code0) like a photometric
        factor's; None when no rep factor is live."""
        rep = self._rep_geo_dev()[0]
        if rep is None:
            return None
        st, cfg = self.state, self.cfg
        lvl0 = st.levels[0]
        rsys = sf.reprojection_system(
            ms.poses_of(st, rep["src"]), ms.poses_of(st, rep["dst"]),
            st.code[rep["src"]], self.cams[0], rep["kp0"], rep["kp1"],
            rep["mvalid"], lvl0.prx0, lvl0.jac, huber_delta=cfg.rep_huber,
            sigma=cfg.rep_sigma, avg_dpt=cfg.avg_dpt, src=rep["src"])
        self.rep_stats["iterations"] += 1
        self.rep_stats["factor_terms"] += int(rep["src"].shape[0])
        return sysm.assemble(
            D, rsys.JtJ, rsys.Jtr,
            sysm.factor_slot_indices(rep["src"], rep["dst"], cfg.max_keyframes,
                                     cfg.code_size), rep["active"])

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

    def _bookkeeping(self):
        """The scheduler's bookkeeping (df_work.cpp:117-136), with a fresh
        draw of every live geometric work's points when ``geo_stochastic``
        is on (sparse_geometric_factor.cpp:153-157)."""
        self.sched.bookkeeping(
            stochastic_geo_resample=(self._sample_geo_points
                                     if self.cfg.geo_stochastic else None))

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
            with span("map.step"):
                self.mapping_step()
            return
        with span("map.segments"):
            self._bookkeeping()
            pool, descent = self._compact_pool(
                extra=self.sched.descent_slots())
            self.run_segments(pool, descent, segs)
            # every segment ran to completion (early exit skips iterations,
            # never a level), so the host schedule replay exhausts each budget
            for _, seg_budget in segs:
                self.sched.update(seg_budget, False)
                self._bookkeeping()
            self.sched.update(0, False)  # sweep remove_after works

    def mapping_step(self):
        """One mapping phase: GN iterations until the next schedule boundary
        or convergence (a run of reference MappingSteps, mapper.cpp:449-552)."""
        if not self.sched.has_work():
            return
        self._bookkeeping()
        budget = self.sched.budget()
        pool = self._compact_pool()
        levels_present = tuple(sorted({int(l) for l, a in
                                       zip(pool.level, pool.active) if a}))
        if not levels_present and (self.sched.rep_pool.active.any()
                                   or self.sched.geo_pool.active.any()):
            levels_present = (0,)
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

    def prewarm(self, img) -> "Mapper":
        """First calls of every mapping path (the JAX ``Mapper.prewarm``,
        which compiles them), on a SCRATCH mapper of this configuration
        built here: its own pools, scheduler and RANSAC generator, so that
        this mapper's state and draws stay as they were. ``img`` is a
        throwaway textured frame [H, W]. One GN iteration over an all-inactive
        pool in every pool bucket (kernel 2 with no active factor, the
        assembly, priors and solve); then, with the model decoder or none (a
        lookup decoder such as ``io/synth.OracleDecoder`` knows only its own
        frames), a keyframe build, a keyframe event with its gate (kernel 3),
        match + RANSAC and photometric works, a one-way frame, the mapping
        runs of the event, and an eviction (Schur + PSD projection). Returns
        the scratch mapper (its pools serve the facade's own warm-up)."""
        mp = Mapper(self.cfg, self.cam, decoder=self.decoder,
                    device=self.device)
        L = self.cfg.pyramid_levels
        for P in mp._pool_buckets():
            z = np.zeros(P, np.int32)
            pool = FactorPool(src=z, dst=z, dst_is_frame=np.zeros(P, bool),
                              level=z, active=np.zeros(P, bool))
            for use_frames in {False, self.cfg.max_frames > 0}:
                mp._run(pool, tuple(range(L)), 1, use_frames)
        if self.decoder is None or isinstance(self.decoder, Decoder):
            ident = se3m.identity(device=self.device)
            s0 = mp.add_keyframe_to_map(img, ident)
            mp.update_map()
            shifted = np.roll(img, 4, axis=1)
            s1 = mp.enqueue_keyframe(
                shifted, SE3(ident.q, torch.tensor([0.02, 0.0, 0.0],
                                                   device=self.device)))
            if self.cfg.max_frames:
                mp.enqueue_frame(shifted, SE3(ident.q, ident.t), s1)
            while mp.has_work():
                mp.mapping_run()
            mp.update_map()
            mp.marginalize_keyframe(s0)
        return mp

    def update_map(self):
        """Re-materialise the depth maps after optimisation (UpdateMap,
        mapper.cpp:859-899)."""
        ms.update_depth_all(self.state, self.cfg.avg_dpt)

    # -- introspection -----------------------------------------------------------

    def dump_state(self, verbose_errors: bool = False) -> dict:
        """Observability dump: work list, factor pools, keyframe table,
        links, marginal priors, the archive of evicted keyframes — the
        PrintWork/verbose-factor logging of the reference
        (mapper.cpp:591-632). With ``verbose_errors`` every active
        keyframe-to-keyframe photometric factor is evaluated once (residual
        and inliers), one ``sfm_error_batch`` call per pool level."""
        out: dict = {"keyframes": [], "works": [], "photo_factors": [],
                     "rep_factors": [], "geo_factors": [], "links": [],
                     "archived": [dict(a, q=a["q"].tolist(), t=a["t"].tolist())
                                  for a in self.archived]}
        ids = self.state.ids.cpu().numpy()
        marg = self.marginals.active.cpu().numpy()
        poses_t = self.state.pose.t.cpu().numpy()
        code_n = torch.linalg.norm(self.state.code, dim=-1).cpu().numpy()
        for s in self.kf_slots:
            out["keyframes"].append({
                "slot": s, "id": int(ids[s]),
                "t": [round(float(x), 4) for x in poses_t[s]],
                "code_norm": round(float(code_n[s]), 4),
                "has_marginal_prior": bool(marg[s]),
            })
        # the native backend keeps its work list in C++
        works = self.sched.wm.work if isinstance(self.sched, PyScheduler) \
            else ()
        for w in works:
            out["works"].append({
                "name": w.name, "level": w.active_level,
                "iters": list(w.iters), "first": w.first,
                "remove": w.remove, "pool_slot": w.pool_slot,
            })
        pool = self.sched.photo_pool
        err = inl = None
        if verbose_errors and np.any(pool.active & ~pool.dst_is_frame):
            err, inl = self._eval_factor_errors()
        for i in range(self.cfg.max_factors):
            if not pool.active[i]:
                continue
            row = {"slot": i, "src": int(pool.src[i]),
                   "dst": int(pool.dst[i]),
                   "dst_is_frame": bool(pool.dst_is_frame[i]),
                   "level": int(pool.level[i])}
            if err is not None and not pool.dst_is_frame[i]:
                row["residual"] = round(float(err[i]), 6)
                row["inliers"] = int(inl[i])
            out["photo_factors"].append(row)
        for name, p in (("rep_factors", self.sched.rep_pool),
                        ("geo_factors", self.sched.geo_pool)):
            for i in np.nonzero(p.active)[0]:
                out[name].append({"slot": int(i), "src": int(p.src[i]),
                                  "dst": int(p.dst[i])})
        out["links"] = [list(pair) for _, pair in self.links_host]
        return out

    def _eval_factor_errors(self):
        """Photometric evaluation of every active keyframe-to-keyframe
        factor at its pool level (PhotometricFactor::error, the
        SaveGraphs/verbose data source): one ``photometric_error_batch``
        call per level present, at the depth of the current codes. Returns
        host arrays (residual, inliers) indexed by pool slot."""
        pool = self.sched.photo_pool
        dev = self.device
        ms.update_depth_all(self.state, self.cfg.avg_dpt)
        errs = np.zeros(self.cfg.max_factors)
        inls = np.zeros(self.cfg.max_factors)
        live = pool.active & ~pool.dst_is_frame
        for l in sorted({int(v) for v in pool.level[live]}):
            sel = np.nonzero(live & (pool.level == l))[0]
            res, inl = fct.photometric_error_batch(
                self.state,
                torch.as_tensor(pool.src[sel].astype(np.int32), device=dev),
                torch.as_tensor(pool.dst[sel].astype(np.int32), device=dev),
                l, self.cams[l], self.params)
            errs[sel] = res.cpu().numpy()
            inls[sel] = inl.cpu().numpy()
        return errs, inls

    def save_graphs(self, path: str):
        """Graphviz export of the factor graph (SaveGraphs,
        mapper.cpp:569-587): keyframe and frame nodes, factor edges labelled
        by kind and level, a diamond per marginal prior."""
        lines = ["graph factors {", "  node [shape=circle];"]
        ids = self.state.ids.cpu().numpy()
        for s in self.kf_slots:
            lines.append(f'  k{s} [label="kf{int(ids[s])}"];')
        for s in self.frame_slots:
            if self.frame_active_host[s] and not self.frame_marg_host[s]:
                lines.append(f'  f{s} [label="fr{s}" shape=box];')
        pool = self.sched.photo_pool
        for i in range(self.cfg.max_factors):
            if pool.active[i]:
                dst = (f"f{int(pool.dst[i])}" if pool.dst_is_frame[i]
                       else f"k{int(pool.dst[i])}")
                lines.append(f'  k{int(pool.src[i])} -- {dst} '
                             f'[label="pho L{int(pool.level[i])}"];')
        for p, kind in ((self.sched.rep_pool, "rep"),
                        (self.sched.geo_pool, "geo")):
            for i in np.nonzero(p.active)[0]:
                lines.append(f'  k{int(p.src[i])} -- k{int(p.dst[i])} '
                             f'[label="{kind}" style=dashed];')
        marg = self.marginals.active.cpu().numpy()
        for s in self.kf_slots:
            if marg[s]:
                lines.append(f'  m{s} [label="prior" shape=diamond];')
                lines.append(f"  m{s} -- k{s};")
        lines.append("}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def geo_state_from_numpy(m: Mapper, geo_pool, dpt_grad) -> Mapper:
    """Set a mapper's geometric factor pool (a ``GeoPool`` of host arrays,
    e.g. the JAX mapper's ``geo_pool``) and its map's depth gradients
    (dpt_grad [K, H, W, 2]) in place; returns ``m``. The works keep their
    pool slots."""
    pool = m.sched.geo_pool
    for name in GeoPool._fields:
        getattr(pool, name)[...] = np.asarray(getattr(geo_pool, name))
    m.state.dpt_grad.copy_(torch.as_tensor(np.array(dpt_grad, np.float32),
                                           device=m.device))
    m.sched.repgeo_version += 1
    return m


def geo_state_to_numpy(m) -> dict:
    """The geometric pool and the depth gradients of a mapper as host
    arrays (the keyword arguments of ``geo_state_from_numpy``); takes the
    port's mapper or the JAX package's."""
    g = m.geo_pool
    dg = m.state.dpt_grad
    return dict(geo_pool=GeoPool(*(np.array(getattr(g, n))
                                   for n in GeoPool._fields)),
                dpt_grad=(dg.detach().cpu().numpy() if torch.is_tensor(dg)
                          else np.array(dg)))
