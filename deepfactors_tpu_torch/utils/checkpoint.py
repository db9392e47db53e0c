"""State checkpoint and resume.

PyTorch port of ``deepfactors_tpu/utils/checkpoint.py``. The reference has
no checkpoint of its optimiser state (only the terminal SaveResults); here
the SLAM state is a few NamedTuples of tensors plus host bookkeeping, so a
checkpoint is a snapshot: the map (keyframe tensors, codes, poses), frame
store, marginal priors, depth priors, tracker pose, trajectory, factor
pools and work schedule, and, beyond the JAX package's, the loop
detector's database and archive, the facade's tracking chain and counters
and the mapper's RANSAC and geometric draw generators, so that a restored
sequential system goes on as the uninterrupted one would.

Layout of the directory (the JAX package's):
  - ``arrays.npz``: the state's tensors, keys ``<name>__<i>`` for the
    trees ``map_state``, ``frames``, ``marginals``, ``dprior``,
    ``tracker_pose``, ``pose_wc``, leaves numbered in ``jax.tree.leaves``
    order (NamedTuple and tuple fields in order, dict keys sorted), so that
    the keys and shapes equal the JAX package's for the same configuration;
  - ``manifest.json``: the host bookkeeping (the JAX package's keys, and
    the port's extra scalars under ``"port"``);
  - ``pools.pkl``: the factor pools and the Python scheduler's work list,
    and the port's extra host arrays; it pickles only numpy arrays and the
    port's own classes.

A checkpoint written by the JAX package cannot be loaded here: its
``pools.pkl`` pickles the JAX package's classes. With the native scheduler
backend the work schedule is not saved (as in the JAX package): the
restored map is consistent and new factors enqueue at the next keyframe.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ..geometry.se3 import SE3
from ..loop.loop_detector import loop_detector_from_numpy, \
    loop_detector_to_numpy
from ..mapping.scheduler import PyScheduler
from ..system import Stats

# the facade's host scalars a resumed run needs besides the JAX package's
_FACADE_SCALARS = (
    "n_frames", "n_lost_frames", "n_relocalizations", "n_evictions",
    "n_local_links", "n_live_global_loops", "n_archived_loops",
    "_last_tracked_nframe", "_last_loop_nframe", "_map_mutation_nframe",
    "_d_rate", "_last_kf_dist", "force_keyframe_flag", "force_frame_flag")
# the facade's host arrays and poses (None where unset)
_FACADE_ARRAYS = ("_last_kf_dists", "_pose_wc_prev", "_reloc_vel",
                  "_newest_kf_pose")


def _leaves(tree) -> list:
    """The leaves of a state tree in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, it):
    """``tree`` with its leaves replaced, in order, from the iterator."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, it) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _trees(system) -> dict:
    m = system.mapper
    return {"map_state": m.state, "frames": m.frames,
            "marginals": m.marginals, "dprior": m.dprior,
            "tracker_pose": (system.tracker.pose_ck.q,
                             system.tracker.pose_ck.t),
            "pose_wc": (system.pose_wc.q, system.pose_wc.t)}


def _pose_np(p):
    return None if p is None else (_host(p.q), _host(p.t))


def _pose_from(v):
    return None if v is None else SE3(v[0], v[1])


def save_checkpoint(path: str, system) -> None:
    """Snapshot a DeepFactors system (``deepfactors_tpu_torch.system``);
    in pipelined mode call ``flush()`` first."""
    if system._pending:
        raise RuntimeError("frames in flight: flush() before a checkpoint")
    os.makedirs(path, exist_ok=True)
    m = system.mapper
    arrays = {f"{name}__{i}": _host(leaf)
              for name, tree in _trees(system).items()
              for i, leaf in enumerate(_leaves(tree))}
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    host = {
        "kf_slots": m.kf_slots,
        "frame_slots": m.frame_slots,
        "kf_ids": {str(k): v for k, v in m.kf_ids.items()},
        "next_kid": m._next_kid,
        "n_links": m.n_links,
        "link_free": m._link_free,
        "links_host": [[li, list(pair)] for li, pair in m.links_host],
        "archived": [{"id": a["id"], "q": _host(a["q"]).tolist(),
                      "t": _host(a["t"]).tolist()} for a in m.archived],
        "curr_kf": system.curr_kf,
        "bootstrapped": system.bootstrapped,
        "tracking_lost": system.tracking_lost,
        "trajectory": [(ts, _host(p.q).tolist(), _host(p.t).tolist())
                       for ts, p in system.trajectory],
        "loop_links": system.loop_links,
        "port": {**{k: getattr(system, k) for k in _FACADE_SCALARS},
                 "stats": list(system.stats),
                 "last_max_delta": m.last_max_delta,
                 "rep_stats": m.rep_stats, "geo_stats": m.geo_stats,
                 "repgeo_version": m.sched.repgeo_version},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(host, f)

    pools = {"pool": m.sched.photo_pool, "rep_pool": m.sched.rep_pool,
             "geo_pool": m.sched.geo_pool,
             "host": {
                 **{k: (_pose_np(getattr(system, k))
                        if k != "_last_kf_dists" else getattr(system, k))
                    for k in _FACADE_ARRAYS},
                 "frame_active_host": m.frame_active_host,
                 "frame_marg_host": m.frame_marg_host,
                 "anchor_pose": _pose_np(m._anchor_pose),
                 "ransac_rng": _host(m._rng.get_state()),
                 "geo_rng": _host(m._geo_rng.get_state())}}
    if isinstance(m.sched, PyScheduler):
        pools["work"] = m.sched.wm
    if system.loop_detector is not None:
        pools["loop"] = loop_detector_to_numpy(system.loop_detector)
    with open(os.path.join(path, "pools.pkl"), "wb") as f:
        pickle.dump(pools, f)


def load_checkpoint(path: str, system) -> None:
    """Restore into an already-constructed system of the same
    configuration (and device)."""
    data = np.load(os.path.join(path, "arrays.npz"))
    m = system.mapper

    def restore(name, template):
        leaves = _leaves(template)
        new = []
        for i, leaf in enumerate(leaves):
            a = data[f"{name}__{i}"]
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}__{i}: checkpoint shape {a.shape}, "
                                 f"system {tuple(leaf.shape)}")
            new.append(torch.as_tensor(a).to(leaf.device, leaf.dtype)
                       if torch.is_tensor(leaf) else a.astype(leaf.dtype))
        return _unflatten(template, iter(new))

    trees = _trees(system)
    m.state = restore("map_state", m.state)
    m.frames = restore("frames", m.frames)
    m.marginals = restore("marginals", m.marginals)
    m.dprior = restore("dprior", m.dprior)
    tq, tt = restore("tracker_pose", trees["tracker_pose"])
    pq, pt = restore("pose_wc", trees["pose_wc"])
    system.pose_wc = SE3(pq, pt)

    with open(os.path.join(path, "manifest.json")) as f:
        host = json.load(f)
    m.kf_slots = list(host["kf_slots"])
    m.frame_slots = list(host["frame_slots"])
    m.kf_ids = {int(k): v for k, v in host["kf_ids"].items()}
    m._next_kid = host["next_kid"]
    m.n_links = host["n_links"]
    m._link_free = list(host["link_free"])
    m.links_host = [(li, tuple(pair)) for li, pair in host["links_host"]]
    m.archived = [{"id": a["id"], "q": np.asarray(a["q"], np.float32),
                   "t": np.asarray(a["t"], np.float32)}
                  for a in host["archived"]]
    system.curr_kf = host["curr_kf"]
    system.bootstrapped = host["bootstrapped"]
    system.tracking_lost = host["tracking_lost"]
    system.trajectory = [(ts, SE3(np.asarray(q, np.float32),
                                  np.asarray(t, np.float32)))
                         for ts, q, t in host["trajectory"]]
    system.loop_links = [tuple(x) for x in host["loop_links"]]
    port = host["port"]
    for k in _FACADE_SCALARS:
        setattr(system, k, port[k])
    system.stats = Stats(*port["stats"])
    m.last_max_delta = port["last_max_delta"]
    m.rep_stats, m.geo_stats = port["rep_stats"], port["geo_stats"]

    with open(os.path.join(path, "pools.pkl"), "rb") as f:
        pools = pickle.load(f)
    for dst, src in ((m.sched.photo_pool, pools["pool"]),
                     (m.sched.rep_pool, pools["rep_pool"]),
                     (m.sched.geo_pool, pools["geo_pool"])):
        for field in dst._fields:
            getattr(dst, field)[:] = getattr(src, field)
    if isinstance(m.sched, PyScheduler) and "work" in pools:
        m.sched.wm = pools["work"]
    # the mapper's device copies of the rep/geo pools are keyed on the
    # version: drop them
    m.sched.repgeo_version = port["repgeo_version"]
    m._repgeo_cache = None
    h = pools["host"]
    system._last_kf_dists = h["_last_kf_dists"]
    for k in _FACADE_ARRAYS[1:]:
        setattr(system, k, _pose_from(h[k]))
    m.frame_active_host = h["frame_active_host"]
    m.frame_marg_host = h["frame_marg_host"]
    aq, at = h["anchor_pose"]
    m._anchor_pose = SE3(torch.as_tensor(aq, device=m.device),
                         torch.as_tensor(at, device=m.device))
    m._rng.set_state(torch.as_tensor(h["ransac_rng"]))
    m._geo_rng.set_state(torch.as_tensor(h["geo_rng"]))
    if system.loop_detector is not None and "loop" in pools:
        loop_detector_from_numpy(system.loop_detector, **pools["loop"])

    # rebind the tracker's keyframe tensors to the restored map
    if system.curr_kf is not None:
        system._set_tracker_keyframe(system.curr_kf)
        system.tracker.pose_ck = SE3(tq, tt)
    system._reset_chain()
