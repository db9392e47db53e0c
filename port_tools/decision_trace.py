"""Per-frame decision trace of a DeepFactors facade, and the
comparison of two traces: the first frame at which their decisions part,
with each decision's value beside its threshold.

The trace reads only what the JAX package's facade and the port's share
(``_decide``'s probe, the mapper's keyframe and frame counters, the rep
pool, the loop counters), so one module serves both and imports neither.
``port_tools/jax_smoke_reference.py --trace FILE`` writes the JAX facade's
trace, ``port_tools/facade_run.py --trace FILE`` the port's (on the card,
or on the CPU with ``--device cpu``). Compare two with
    python3 port_tools/decision_trace.py A.jsonl B.jsonl
which prints the first parting frame, its decisions in both runs with the
margins to their thresholds, and the largest pose difference before it.

One JSON line a processed frame: ``frame`` (its timestamp; in pipelined
mode the decisions are those of the frame the call retired), ``kf`` (the
keyframe tracked against), ``lost``, ``reloc`` (relocalised), ``keyframe``
(a keyframe was built), ``oneway`` (a one-way frame was enqueued), the
probe's ``error``, ``inliers``, ``rot``, ``dist`` (d_full to kf),
``d_trans`` (to kf), ``fr_trans`` (the smallest to a live one-way frame),
``d_kfs`` (d_full to every live keyframe), ``stale`` and ``d_rate`` (a
pipelined facade's stale flag and keyframe-distance rate after the
frame), ``q``/``t`` (the tracked
camera-to-world pose), ``loops`` (local, live global, archived), ``rep``
(the live rep factors after the frame as [src, dst, surviving matches]:
a direction with fewer than 8 adds none). The first line holds the
thresholds.
"""
import json
import sys

import numpy as np


def attach(df, path):
    """Wrap ``df``'s frame processing to append one line a frame to
    ``path``. Returns a function that closes the file."""
    cfg = df.cfg
    f = open(path, "w")
    f.write(json.dumps({"thresholds": {
        k: getattr(cfg, k) for k in (
            "keyframe_mode", "dist_threshold", "inlier_threshold",
            "combined_threshold", "frame_dist_threshold",
            "tracking_error_threshold", "tracking_dist_threshold",
            "min_tracking_inliers", "loop_max_dist", "loop_min_similarity")
    }}) + "\n")
    m = df.mapper
    cur = {}
    decide, process = df._decide, df.process_frame
    enqueue_frame = m.enqueue_frame

    def traced_decide(*a, **kw):
        probe, kf = a[4], a[6]
        d = np.asarray(probe["d_full"], np.float64)
        fr = [float(probe["fr_trans"][i])
              for i in range(len(m.frame_active_host))
              if m.frame_active_host[i] and not m.frame_marg_host[i]]
        cur.update(stale=bool(kw.get("stale", False)))
        cur.update(kf=int(kf), error=float(probe["error"]),
                   inliers=float(probe["inliers"]), rot=float(probe["rot"]),
                   dist=float(d[kf]), d_trans=float(probe["d_trans"][kf]),
                   fr_trans=min(fr) if fr else None,
                   d_kfs={int(s): float(d[s]) for s in m.kf_slots})
        out = decide(*a, **kw)
        cur.update(d_rate=float(df._d_rate))
        return out

    def traced_enqueue_frame(*a, **kw):
        cur["oneway"] = True
        return enqueue_frame(*a, **kw)

    def traced_process(timestamp, img):
        cur.clear()
        n_kid, n_reloc = m._next_kid, df.n_relocalizations
        process(timestamp, img)
        p = df.pose_wc
        pool = m.rep_pool
        rec = dict(
            frame=float(timestamp), lost=bool(df.tracking_lost),
            reloc=df.n_relocalizations > n_reloc,
            keyframe=m._next_kid > n_kid, oneway=cur.pop("oneway", False),
            q=[float(x) for x in np.asarray(p.q)],
            t=[float(x) for x in np.asarray(p.t)],
            loops=[df.n_local_links, df.n_live_global_loops,
                   df.n_archived_loops],
            rep=sorted([int(pool.src[i]), int(pool.dst[i]),
                        int(np.asarray(pool.mvalid[i]).sum())]
                       for i in np.nonzero(pool.active)[0]),
            **cur)
        f.write(json.dumps(rec) + "\n")
        f.flush()

    df._decide = traced_decide
    df.process_frame = traced_process
    m.enqueue_frame = traced_enqueue_frame
    return f.close


DECISIONS = ("kf", "lost", "reloc", "keyframe", "oneway", "loops", "rep")


def _read(path):
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    return lines[0]["thresholds"], {r["frame"]: r for r in lines[1:]}


def _margins(r, th):
    """The decisions' inputs beside their thresholds (value - threshold)."""
    out = {}
    if "dist" in r:
        out["keyframe: dist - dist_threshold"] = r["dist"] - th["dist_threshold"]
        out["keyframe: inliers - inlier_threshold"] = (
            r["inliers"] - th["inlier_threshold"])
        out["one-way: d_trans - frame_dist_threshold"] = (
            r["d_trans"] - th["frame_dist_threshold"])
        if r.get("fr_trans") is not None:
            out["one-way: fr_trans - frame_dist_threshold"] = (
                r["fr_trans"] - th["frame_dist_threshold"])
        out["lost: error - tracking_error_threshold"] = (
            r["error"] - th["tracking_error_threshold"])
        if r.get("d_kfs"):
            d = sorted(r["d_kfs"].items(), key=lambda kv: kv[1])
            out["closest keyframes (slot, d_full)"] = d[:3]
    return out


def compare(path_a, path_b):
    th, a = _read(path_a)
    _, b = _read(path_b)
    frames = sorted(set(a) & set(b))
    worst = (0.0, None)
    for fr in frames:
        ra, rb = a[fr], b[fr]
        parted = [k for k in DECISIONS if ra.get(k) != rb.get(k)]
        if parted:
            print(json.dumps({"first_parting_frame": fr, "decisions": parted,
                              "max_pose_t_diff_before_m": worst[0],
                              "at_frame": worst[1]}))
            for name, r in ((path_a, ra), (path_b, rb)):
                print(json.dumps({"run": name,
                                  **{k: r.get(k) for k in DECISIONS},
                                  "margins": _margins(r, th)}))
            return fr
        dt = float(np.linalg.norm(np.subtract(ra["t"], rb["t"])))
        if dt > worst[0]:
            worst = (dt, fr)
    print(json.dumps({"first_parting_frame": None, "frames": len(frames),
                      "max_pose_t_diff_m": worst[0], "at_frame": worst[1]}))
    return None


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    compare(sys.argv[1], sys.argv[2])
