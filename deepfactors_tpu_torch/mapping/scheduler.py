"""Work scheduling for the Mapper: a Python backend and the native C++ one.

Own copy of the reference-semantics scheduler of
``deepfactors_tpu/mapping/scheduler.py`` and the Work classes of
``deepfactors_tpu/mapping/mapper.py`` (df_work.cpp:99-249, 316-347,
work_manager.cpp:25-143), with photometric, reprojection and geometric
works. ``make_scheduler`` returns the C++ backend (native/scheduler.cpp,
through ``deepfactors_tpu_torch.native``) when the config sets
``use_native_scheduler``, else the Python one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .mapper_pools import _empty_geo_pool, _empty_pool, _empty_rep_pool


class Work:
    """Coarse-to-fine per-factor schedule state."""

    def __init__(self, iters: Sequence[int], remove_after: bool = False):
        self.iters = list(iters)
        self.orig_iters = list(iters)
        self.active_level = len(iters) - 1
        self.first = True
        self.remove = False
        self.remove_after = remove_after
        self.name = "work"
        self.child: Optional["Work"] = None

    def add_child(self, child: "Work"):
        self.child = child

    def is_new_level_start(self) -> bool:
        return (self.active_level >= 0
                and self.iters[self.active_level]
                == self.orig_iters[self.active_level])

    def update(self):
        if self.active_level >= 0:
            self.iters[self.active_level] -= 1
            if self.iters[self.active_level] < 0:
                self.active_level -= 1
        if self.remove_after and self.active_level < 0:
            self.remove = True

    def finished(self) -> bool:
        # <= not ==: an update tick and a convergence signal in the same
        # scheduler update can skip a level past -1
        if self.remove_after:
            return self.active_level <= -2
        return self.active_level <= -1

    def signal_no_relinearize(self):
        if not self.first and self.active_level >= 0:
            self.active_level -= 1


class PhotoWork(Work):
    """OptimizePhoto: one directed photometric factor whose level follows the
    work schedule (df_work.cpp:198-249)."""

    def __init__(self, src: int, dst: int, dst_is_frame: bool,
                 iters: Sequence[int], remove_after: bool = False):
        super().__init__(iters, remove_after)
        self.src = src
        self.dst = dst
        self.dst_is_frame = dst_is_frame
        self.pool_slot: Optional[int] = None
        self.name = f"photo {src}->{'f' if dst_is_frame else ''}{dst}"


class RepWork(Work):
    """OptimizeRep: one reprojection factor, single level
    (df_work.cpp:316-347). The match data is computed once, at
    construction, like the reference's constructor."""

    def __init__(self, src: int, dst: int, kp0, kp1, mvalid, iters: int,
                 remove_after: bool = False):
        super().__init__([iters], remove_after)
        self.src = src
        self.dst = dst
        self.kp0 = kp0          # [M, 2] np
        self.kp1 = kp1          # [M, 2] np
        self.mvalid = mvalid    # [M] np bool
        self.pool_slot: Optional[int] = None
        self.name = f"rep {src}->{dst}"


class GeoWork(Work):
    """OptimizeGeo: one sparse geometric factor, single level
    (df_work.cpp:252-297). Its sample points are drawn at construction."""

    def __init__(self, src: int, dst: int, points, iters: int,
                 remove_after: bool = False):
        super().__init__([iters], remove_after)
        self.src = src
        self.dst = dst
        self.points = points    # [N, 2] np
        self.pool_slot: Optional[int] = None
        self.name = f"geo {src}->{dst}"


class WorkManager:
    """Work list + bookkeeping (work_manager.cpp:25-143 semantics)."""

    def __init__(self):
        self.work: list[Work] = []

    def add(self, w: Work) -> Work:
        self.work.append(w)
        return w

    def empty(self) -> bool:
        return len(self.work) == 0

    def update(self):
        for w in self.work:
            w.update()

    def signal_no_relinearize(self):
        for w in self.work:
            w.signal_no_relinearize()

    def sweep_finished(self):
        done = [w for w in self.work if w.finished()]
        self.work = [w for w in self.work if not w.finished()]
        for w in done:
            if w.child is not None:
                self.work.append(w.child)
                w.child = None

    def erase_involving(self, slot: int, is_frame: bool):
        """WorkManager::Erase — drop works touching a removed frame/keyframe."""
        def touches(w):
            if not isinstance(w, PhotoWork):
                return False
            if is_frame:
                return w.dst_is_frame and w.dst == slot
            return w.src == slot or (not w.dst_is_frame and w.dst == slot)

        self.work = [w for w in self.work if not touches(w)]


class PyScheduler:
    """Work list + photometric, reprojection and geometric factor pools."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.wm = WorkManager()
        # bumped on every rep or geo pool mutation: the Mapper caches device
        # copies of the (host-mutated) pools keyed on this version
        self.repgeo_version = 0
        self.photo_pool = _empty_pool(cfg.max_factors)
        self.rep_pool = _empty_rep_pool(cfg.max_rep_factors,
                                        cfg.max_keypoints)
        self.geo_pool = _empty_geo_pool(cfg.max_geo_factors, cfg.geo_npoints)

    def add_photo(self, src, dst, dst_is_frame, iters, remove_after=False,
                  replace=False):
        if replace and not dst_is_frame:
            for i in range(self.cfg.max_factors):
                if (self.photo_pool.active[i]
                        and not self.photo_pool.dst_is_frame[i]
                        and self.photo_pool.src[i] == src
                        and self.photo_pool.dst[i] == dst):
                    self.photo_pool.active[i] = False
            for w in list(self.wm.work):
                if (isinstance(w, PhotoWork) and not w.dst_is_frame
                        and w.src == src and w.dst == dst):
                    self.wm.work.remove(w)
        return self.wm.add(PhotoWork(src, dst, dst_is_frame, iters,
                                     remove_after=remove_after))

    def add_rep(self, src, dst, iters, kp0, kp1, mvalid):
        """A reprojection work. Replace semantics: a re-linked pair refreshes
        its factor instead of leaking a second pool slot."""
        self.repgeo_version += 1
        for i in range(self.cfg.max_rep_factors):
            if (self.rep_pool.active[i] and self.rep_pool.src[i] == src
                    and self.rep_pool.dst[i] == dst):
                self.rep_pool.active[i] = False
        for w in list(self.wm.work):
            if isinstance(w, RepWork) and w.src == src and w.dst == dst:
                self.wm.work.remove(w)
        return self.wm.add(RepWork(src, dst, kp0, kp1, mvalid, iters))

    def add_geo(self, src, dst, iters, points, parent=None):
        """A geometric work; with ``parent`` it is that work's child and
        starts when the parent finishes (the keyframe event's geometric
        factors follow its photometric ones)."""
        self.repgeo_version += 1
        w = GeoWork(src, dst, points, iters)
        if parent is not None:
            parent.add_child(w)
        else:
            self.wm.add(w)
        return w

    def erase_frame(self, fslot: int):
        for w in list(self.wm.work):
            if isinstance(w, PhotoWork) and w.dst_is_frame and w.dst == fslot:
                if w.pool_slot is not None:
                    self.photo_pool.active[w.pool_slot] = False
        self.wm.erase_involving(fslot, is_frame=True)
        for i in range(self.cfg.max_factors):
            if (self.photo_pool.active[i] and self.photo_pool.dst_is_frame[i]
                    and self.photo_pool.dst[i] == fslot):
                self.photo_pool.active[i] = False

    def erase_keyframe(self, slot: int):
        """Drop every work and pool factor touching an evicted keyframe slot
        (the WorkManager::Erase analogue for keyframes: the reference never
        evicts, see ``Mapper.marginalize_keyframe``). A work's pool entry
        carries the work's own src and dst, so the sweeps over the pools
        free it too."""
        self.repgeo_version += 1

        def touches(w):
            if isinstance(w, (RepWork, GeoWork)):
                return w.src == slot or w.dst == slot
            return w.src == slot or (not w.dst_is_frame and w.dst == slot)

        self.wm.work = [w for w in self.wm.work if not touches(w)]
        p = self.photo_pool
        for i in range(self.cfg.max_factors):
            if p.active[i] and (p.src[i] == slot
                                or (not p.dst_is_frame[i]
                                    and p.dst[i] == slot)):
                p.active[i] = False
        for r in (self.rep_pool, self.geo_pool):
            r.active[(r.src == slot) | (r.dst == slot)] = False

    def bookkeeping(self, stochastic_geo_resample=None):
        """Work::Bookkeeping (df_work.cpp:117-136): place new works and
        level changes into the pools, free removed works. A reprojection
        or geometric work takes its pool slot once, with its match data or
        sample points, and keeps it after the work finishes (the factor
        stays in the graph until one of its keyframes is evicted). With
        ``stochastic_geo_resample`` (a function returning [N, 2] points)
        every live geometric work that holds a slot draws new points
        (sparse_geometric_factor.cpp:153-157)."""
        def alloc(pool, name):
            free = np.nonzero(~pool.active)[0]
            if len(free) == 0:
                raise RuntimeError(f"{name} factor pool exhausted")
            return int(free[0])

        for w in self.wm.work:
            rep = isinstance(w, RepWork)
            geo = isinstance(w, GeoWork)
            pool = (self.rep_pool if rep else self.geo_pool if geo
                    else self.photo_pool)
            if w.remove:
                if w.pool_slot is not None:
                    pool.active[w.pool_slot] = False
                    w.pool_slot = None
                    self.repgeo_version += rep or geo
                w.active_level = -2
                continue
            if geo:
                if w.first:
                    self.repgeo_version += 1
                    w.first = False
                    i = w.pool_slot = alloc(pool, "geo")
                    pool.src[i], pool.dst[i] = w.src, w.dst
                    pool.points[i] = w.points
                    pool.active[i] = True
                elif (stochastic_geo_resample is not None
                      and w.pool_slot is not None):
                    pool.points[w.pool_slot] = stochastic_geo_resample()
                    self.repgeo_version += 1
            elif rep:
                if w.first:
                    self.repgeo_version += 1
                    w.first = False
                    i = w.pool_slot = alloc(pool, "rep")
                    M = w.kp0.shape[0]
                    pool.src[i], pool.dst[i] = w.src, w.dst
                    pool.kp0[i, :M] = w.kp0
                    pool.kp1[i, :M] = w.kp1
                    pool.mvalid[i] = False
                    pool.mvalid[i, :M] = w.mvalid
                    pool.active[i] = True
            elif w.first or (w.active_level >= 0 and w.is_new_level_start()):
                w.first = False
                if w.pool_slot is None:
                    w.pool_slot = alloc(pool, "photo")
                i = w.pool_slot
                pool.src[i] = w.src
                pool.dst[i] = w.dst
                pool.dst_is_frame[i] = w.dst_is_frame
                pool.level[i] = max(w.active_level, 0)
                pool.active[i] = True

    def budget(self) -> int:
        budgets = [w.iters[w.active_level] + 1 for w in self.wm.work
                   if w.active_level >= 0]
        return max(1, min(budgets)) if budgets else 1

    def update(self, iters_done: int, converged: bool):
        for _ in range(iters_done):
            self.wm.update()
        if converged:
            self.wm.signal_no_relinearize()
        self.wm.sweep_finished()

    def has_work(self) -> bool:
        return not self.wm.empty()

    def fused_sig(self):
        """(active_level, iters, orig_iters) when every outstanding
        photometric work shares one schedule state (the whole C2F descent can
        then run as one segment sequence), else None. Reprojection and
        geometric works ride along: every GN iteration assembles the live
        rep and geo pools anyway, so they only need their schedules ticked
        by the host replay."""
        sig = None
        for w in self.wm.work:
            if w.child is not None or w.remove:
                return None
            if isinstance(w, (RepWork, GeoWork)):
                continue
            s = (w.active_level, tuple(w.iters), tuple(w.orig_iters))
            if sig is None:
                sig = s
            elif s != sig:
                return None
        return sig

    def descent_slots(self) -> np.ndarray:
        """Photo-pool slots owned by live works (the descending factor set)."""
        out = np.zeros(self.cfg.max_factors, bool)
        for w in self.wm.work:
            if isinstance(w, PhotoWork) and w.pool_slot is not None:
                out[w.pool_slot] = True
        return out

    def tick_empty(self):
        self.wm.update()
        self.wm.sweep_finished()


class NativeBackend:
    """C++ scheduler backend (native/scheduler.cpp): the work list and the
    pools' (src, dst, level, active) live in C++ and are mirrored into the
    host pools after each bookkeeping; a reprojection or geometric work's
    payload waits here until its work owns a pool slot. Works are integer
    ids (``add_photo`` returns one; ``add_geo``'s ``parent`` takes one).
    As in the JAX package, ``bookkeeping`` does not resample geometric
    points (``stochastic_geo_resample`` is ignored)."""

    def __init__(self, cfg):
        from .. import native

        self.cfg = cfg
        self.native = native
        self.repgeo_version = 0
        self.ns = native.NativeScheduler(
            cfg.max_factors, cfg.max_rep_factors, cfg.max_geo_factors)
        self.photo_pool = _empty_pool(cfg.max_factors)
        self.rep_pool = _empty_rep_pool(cfg.max_rep_factors, cfg.max_keypoints)
        self.geo_pool = _empty_geo_pool(cfg.max_geo_factors, cfg.geo_npoints)
        # payloads waiting for slot placement: work_id -> payload
        self._rep_payloads: dict = {}
        self._geo_payloads: dict = {}

    def add_photo(self, src, dst, dst_is_frame, iters, remove_after=False,
                  replace=False):
        if replace and not dst_is_frame:
            self.ns.replace_pair(self.native.PHOTO, src, dst)
        return self.ns.add_work(self.native.PHOTO, src, dst, dst_is_frame,
                                list(iters), remove_after)

    def add_rep(self, src, dst, iters, kp0, kp1, mvalid):
        self.repgeo_version += 1
        self.ns.replace_pair(self.native.REP, src, dst)
        wid = self.ns.add_work(self.native.REP, src, dst, False, [iters])
        self._rep_payloads[wid] = (kp0, kp1, mvalid)
        return wid

    def add_geo(self, src, dst, iters, points, parent=None):
        self.repgeo_version += 1
        wid = self.ns.add_work(self.native.GEO, src, dst, False, [iters],
                               parent=parent if isinstance(parent, int) else 0)
        self._geo_payloads[wid] = points
        return wid

    def erase_frame(self, fslot: int):
        self.repgeo_version += 1
        self.ns.erase_frame(fslot)

    def erase_keyframe(self, slot: int):
        self.repgeo_version += 1
        self.ns.erase_keyframe(slot)

    def bookkeeping(self, stochastic_geo_resample=None):
        self.ns.bookkeeping()
        for kind, pool in ((self.native.PHOTO, self.photo_pool),
                           (self.native.REP, self.rep_pool),
                           (self.native.GEO, self.geo_pool)):
            src, dst, level, isf, act = self.ns.pool(kind)
            pool.src[:] = src
            pool.dst[:] = dst
            if hasattr(pool, "level"):
                pool.level[:] = level
            if hasattr(pool, "dst_is_frame"):
                pool.dst_is_frame[:] = isf
            pool.active[:] = act
        # place the payloads whose works now own slots
        for wid in list(self._rep_payloads):
            slot = self.ns.work_slot(wid)
            if slot >= 0:
                self.repgeo_version += 1
                kp0, kp1, mvalid = self._rep_payloads.pop(wid)
                M = kp0.shape[0]
                self.rep_pool.kp0[slot, :M] = kp0
                self.rep_pool.kp1[slot, :M] = kp1
                self.rep_pool.mvalid[slot] = False
                self.rep_pool.mvalid[slot, :M] = mvalid
        for wid in list(self._geo_payloads):
            slot = self.ns.work_slot(wid)
            if slot >= 0:
                self.repgeo_version += 1
                self.geo_pool.points[slot] = self._geo_payloads.pop(wid)

    def budget(self) -> int:
        return self.ns.budget()

    def update(self, iters_done: int, converged: bool):
        self.ns.update(iters_done, converged)

    def has_work(self) -> bool:
        return self.ns.has_work()

    def fused_sig(self):
        return self.ns.fused_sig()

    def descent_slots(self) -> np.ndarray:
        return self.ns.descent_slots()

    def tick_empty(self):
        self.ns.update(1, False)


def make_scheduler(cfg):
    """The native backend when ``cfg.use_native_scheduler`` (its library
    builds at first use and a failed build raises), else the Python one."""
    if getattr(cfg, "use_native_scheduler", False):
        return NativeBackend(cfg)
    return PyScheduler(cfg)
