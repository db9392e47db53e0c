"""Driver of the large map sharded over several cards: the port's
``LargeMapBA`` over a ``torch.distributed`` world of ``cards`` ranks, one a
card, each holding its shard of the factors and the replicated poses,
codes, system and solve.

Rank 0 is this process, on the harness's device. ``setup`` first starts
ranks 1.. as processes of their own (this module run with ``--worker``;
never forked), each on its own card, so that their imports overlap rank
0's build of the kernels and of its shard; they wait for a ``ready`` file
that rank 0 writes once the kernels are built, so that no two processes
build them at once. A watchdog thread ends every rank, and this process,
as soon as one rank fails; a rank whose parent is gone ends itself. Every
rank renders, takes Sobel gradients of, and decodes only the batches of
16 keyframes (aligned as the reference's) that hold a keyframe its shard
touches, then builds its shard
(``large_map.build_problem(world_size=, rank=)``), and only then joins the
world through ``parallel/multihost.initialize`` (NCCL on cards, gloo on
the CPU). Starts are drawn on the host from the seed, alike in every rank.

Rank 0 drives every solve: a broadcast of (command, start index, fault,
keep) reaches the other ranks before each; every rank then runs the same
``LargeMapBA.run``, whose step all-reduces the system. Each solve ends with
rank 0's poses and codes on its host. ``check`` stops the other ranks
(they write the results of the window's solves, and their peak memory,
to files), leaves the world, frees the program's state and holds the
window's solves to the reference (``reference/largemap4.py``), which
renders and decodes every keyframe itself and spreads its factors over
the cards; ``replica_gap`` holds every rank's results to rank 0's.

From the end of ``setup`` until ``stop`` the harness's device report counts
every card of the world (``report_cards``), not rank 0's alone; the peak
it reports stays rank 0's, and each rank's goes to the log.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from portbench import synth
from portbench.drivers import largemap as lm
from portbench.trace import span

FAULTS = ("unchanged", "half", "altered", "exchange")
CODES = {None: 0, "unchanged": 1, "half": 2, "altered": 3, "exchange": 4}
SOLVE, STOP = 1, 0
ROOT = Path(__file__).resolve().parents[2]
RANK_TIMEOUT_S = 600.0     # a collective that waits longer fails
STOP_TIMEOUT_S = 120.0     # the other ranks' exit after the stop


def _pairs(links):
    return [p for i, j in links for p in ((i, j), (j, i))]


def shard_keyframes(K: int, links, world: int, rank: int) -> list:
    """The keyframes rank ``rank``'s factors touch (the rows
    ``build_problem`` gives it: the factor table split in order)."""
    pairs = _pairs(links)
    per = -(-len(pairs) // world)
    return sorted({k for p in pairs[rank * per:(rank + 1) * per] for k in p})


def starts(cfg, traffic, seed, K):
    """(world q, world t) numpy, for the renderer; the starts [(q, t)] on
    the host: the truth relative to keyframe 0 moved off by the noise,
    keyframe 0 held. Drawn on the CPU, so that every rank draws alike."""
    from portbench.reference import largemap as ref
    qw, tw, q_true, t_true = lm._truth(cfg, K, torch.device("cpu"))
    g = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    n = traffic["starts"]
    noise = torch.randn((n, K, 6), generator=g)
    noise[..., :3] *= cfg["noise_t_m"]
    noise[..., 3:] *= cfg["noise_r_rad"]
    noise[:, 0] = 0.0
    return qw, tw, [ref.retract(q_true, t_true, noise[i]) for i in range(n)]


def decoder(cfg, seed, device):
    """(the program's decoder, the decoder's weights where the seed made
    them, else None)."""
    from deepfactors_tpu_torch.models.decoder import (Decoder, NetworkConfig,
                                                      load_params)
    net_cfg = NetworkConfig(**{k: cfg[k] for k in (
        "code_size", "pyramid_levels", "input_width", "input_height",
        "avg_dpt", "fx", "fy", "u0", "v0", "base_ch", "pred_head")})
    if cfg["weights"]:
        return Decoder(net_cfg, device=device, params=load_params(
            str(ROOT / cfg["weights"]))), None
    p = lm.decoder_init(cfg, seed, device)
    dec = Decoder(net_cfg, device=device)
    dec.module.load_state_dict({k[len("decoder."):]: v for k, v in p.items()})
    return dec, p


def build(cfg, traffic, seed, device, world, rank, log):
    """This rank's part of the problem: its keyframes rendered and decoded,
    its shard of the factors (no collective: the world need not be up)."""
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.parallel import large_map

    t0 = time.perf_counter()
    K, H, W = traffic["K"], cfg["input_height"], cfg["input_width"]
    CS = cfg["code_size"]
    cam = lm._camera(cfg)
    links = lm._links(K, cfg["back"])
    qw, tw, st = starts(cfg, traffic, seed, K)
    st = [(q.to(device), t.to(device)) for q, t in st]
    mine = shard_keyframes(K, links, world, rank)
    scene = synth.random_room(seed, n_boxes=cfg["n_boxes"])
    dec, dec_params = decoder(cfg, seed, device)
    # full-size planes, zero where this rank's factors do not look
    images = torch.zeros((K, H, W), device=device)
    grads = torch.zeros((K, H, W, 2), device=device)
    prx0 = torch.zeros((K, H, W), device=device)
    std = torch.zeros((K, H, W), device=device)
    jac = torch.zeros((K, H, W, CS), device=device)
    # in the batches of 16 the one-process map takes (and the reference):
    # a keyframe is decoded in the same batch whichever rank decodes it, so
    # that the ranks sharing it hold it alike, to the bit
    for a in sorted({k - k % 16 for k in mine}):
        img = synth.render_aa(scene, cam, qw[a:a + 16], tw[a:a + 16], H, W,
                              device=device)[0]
        images[a:a + 16] = img
        grads[a:a + 16] = synth.sobel_gradients(img)
        out = dec.raw_outputs_T(img)
        j = out["jac"][0]
        prx0[a:a + 16] = out["prx0"][0] + torch.einsum("bchw,bc->bhw", j,
                                                        out["code_pred"])
        jac[a:a + 16] = j.permute(0, 2, 3, 1)
        std[a:a + 16] = out["stdev"][0]
    problem = large_map.build_problem(
        images, prx0, jac, std, grads, SE3(*st[0]),
        torch.zeros((K, CS), device=device), links, world, rank)
    del images, grads, prx0, std, jac, dec
    log(f"set-up: rank {rank}: {len(mine)} keyframes needed, in batches of "
        f"16 rendered and decoded, "
        f"{int(problem.fd.src.shape[0])} factors gathered, "
        f"{time.perf_counter() - t0:.2f} s")
    return dict(cfg=cfg, traffic=traffic, device=device, cam=cam,
                links=links, starts=st, problem=problem, K=K, CS=CS,
                P=int(problem.fd.src.shape[0]), world=world, rank=rank,
                alter=None, fault=None, applied=set(),
                dec_params=dec_params, scene=scene, qw=qw, tw=tw)


def join(state, coord, cuda):
    """This rank into the world at ``coord``, and the BA over it."""
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.parallel import large_map, multihost

    cfg, cam, device = state["cfg"], state["cam"], state["device"]
    multihost.initialize(coord, state["world"], state["rank"],
                         local_device_ids=[device.index or 0]
                         if cuda else None,
                         device=device.type, timeout_s=RANK_TIMEOUT_S)
    state["group"] = multihost.global_group()
    pcam = PinholeCamera.create(cam.fx, cam.fy, cam.u0, cam.v0, cam.width,
                                cam.height)
    state["ba"] = large_map.LargeMapBA(
        state["K"], state["CS"], pcam, ds.SfmParams(**cfg["sfm"]),
        group=state["group"], **cfg["priors"])


def _run(state, i):
    """Solve ``i`` on this rank: [K, 7 + CS] (q, t, codes) on the device."""
    q, t = state["starts"][i % len(state["starts"])]
    problem = state["problem"]._replace(
        pose_q=q, pose_t=t, codes=torch.zeros_like(state["problem"].codes))
    est, codes, _ = state["ba"].run(problem, iters=state["cfg"]["iters"])
    return torch.cat([est.q, est.t, codes], dim=1)


def _command(state, cmd, i=0, keep=0):
    """Rank 0's word to the other ranks (a no-op in a world of one)."""
    if state["group"] is None:
        return
    import torch.distributed as dist
    word = torch.tensor([cmd, i, CODES[state["fault"]], keep],
                        dtype=torch.int64, device=state["comm"])
    dist.broadcast(word, src=0, group=state["group"])


def _solve(state, i, keep=0):
    _command(state, SOLVE, i, keep)
    out = _run(state, i)
    if state["alter"] is not None:
        out = state["alter"](out)
    return out


def apply_fault(state, fault):
    """The part of a fault this rank plays (each rank applies it once): half
    of every shard left inactive (as the one-card driver plants it); the
    last rank's system left out of the exchange (zeroed before each
    ``all_reduce``)."""
    if fault in state["applied"]:
        return
    state["applied"].add(fault)
    if fault == "half":
        lm.plant(state, "half")
    elif fault == "exchange" and state["rank"] == state["world"] - 1:
        import torch.distributed as dist
        real = dist.all_reduce

        def left_out(x, *a, **kw):
            x.zero_()
            return real(x, *a, **kw)
        dist.all_reduce = left_out


# ---------------------------------------------------------------------------
# rank 0: the harness's interface
# ---------------------------------------------------------------------------

class Ranks:
    """Ranks 1..n-1 as processes of their own, their outputs in files. A
    watchdog ends them all, and this process, when one fails before
    ``stop``; ``close`` ends any still running."""

    def __init__(self, spec: dict, nproc: int):
        self.tmp = tempfile.TemporaryDirectory(prefix="largemap4_")
        d = Path(self.tmp.name)
        (d / "spec.json").write_text(json.dumps(spec))
        self.coord = "file://" + str(d / "rendezvous")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.logs, self.procs = [], []
        self.stopping = self.closed = False
        try:
            for r in range(1, nproc):
                f = open(d / f"rank{r}.log", "w+")
                self.logs.append(f)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "portbench.drivers.largemap4",
                     "--worker", str(d / "spec.json"), "--coord", self.coord,
                     "--nproc", str(nproc), "--proc-id", str(r),
                     "--parent", str(os.getpid())],
                    stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        except BaseException:
            self.close()
            raise
        atexit.register(self.close)
        threading.Thread(target=self._watch, daemon=True).start()

    def ready(self) -> None:
        """Let the ranks go on past their imports (the kernels are built)."""
        (Path(self.tmp.name) / "ready").touch()

    def out(self, r: int) -> Path:
        return Path(self.tmp.name) / f"rank{r}.npz"

    def tail(self, r: int, n: int = 3000) -> str:
        if not self.logs:
            return ""
        f = self.logs[r - 1]
        f.flush()
        f.seek(0)
        return f.read()[-n:]

    def _watch(self):
        while not self.closed:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code is None or (code == 0 and self.stopping) or \
                        self.closed:
                    continue
                print(f"largemap4: rank {r} ended with {code}:\n"
                      f"{self.tail(r)}", file=sys.stderr, flush=True)
                self._kill()
                os._exit(1)
            time.sleep(0.2)

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def wait(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        for r, p in enumerate(self.procs, 1):
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self._kill()
                raise RuntimeError(f"rank {r} did not stop:\n{self.tail(r)}")

    def close(self):
        self.closed = True
        self._kill()
        for p in self.procs:
            p.wait()
        for f in self.logs:
            f.close()
        self.logs = []
        self.tmp.cleanup()


def _devices(cfg, device):
    """The world's devices: cards 0..n-1, or the CPU n times."""
    n = cfg["cards"]
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * n


def report_cards(devices):
    """Widen the harness's device report, which counts rank 0's card
    alone, to the world: its ``count`` becomes the number of the world's
    cards of rank 0's kind. Returns the report it replaced, which ``stop``
    puts back."""
    from portbench import harness
    own = harness.device_kind

    def kind(device):
        out = own(device)
        if device.type == "cuda":
            out["count"] = sum(torch.cuda.get_device_name(d) == out["kind"]
                               for d in dict.fromkeys(devices))
        return out
    harness.device_kind = kind
    return own


def setup(cfg, traffic, seed, device, log=print):
    t0 = time.perf_counter()
    n = cfg["cards"]
    cuda = device.type == "cuda"
    if cuda and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} cards needed, "
                           f"{torch.cuda.device_count()} present")
    # the other ranks import while this one builds the kernels and its shard
    ranks = Ranks({"cfg": cfg, "traffic": traffic, "seed": int(seed),
                   "device": device.type, "spawned": time.time()}, n)
    try:
        if cuda:
            from deepfactors_tpu_torch.ops.kernels import build as kernels
            kernels.build_all()
        ranks.ready()
        log(f"set-up: kernels ready, {time.perf_counter() - t0:.2f} s")
        state = build(cfg, traffic, seed, device, n, 0, log)
        join(state, ranks.coord, cuda)
        log(f"set-up: rank 0 joined the world, "
            f"{time.perf_counter() - t0:.2f} s")
    except BaseException:
        ranks.close()
        raise
    state.update(ranks=ranks, comm=device, devices=_devices(cfg, device),
                 warm=traffic["warm_solves"])
    for i in range(traffic["warm_solves"]):         # warm-up, as the window
        _solve(state, i).cpu()
    log(f"set-up: warm solves done, {time.perf_counter() - t0:.2f} s")
    for r in range(1, n):
        log("".join(ln for ln in ranks.tail(r).splitlines(True)
                    if ln.startswith("set-up: rank")).rstrip())
    if cuda:
        # the result line reports every card the world runs on
        state["own_report"] = report_cards(state["devices"])
    return state


def window(state, seconds, max_units=None, traced=False):
    """Solves back to back until ``seconds`` have passed (or ``max_units``
    solves are done): ba_iter_ms is the time to the end of the last solve
    over the iterations done. ``units`` adds the bytes rank 0 all-reduced,
    where the program counts them."""
    from deepfactors_tpu_torch.parallel import dist_ba
    counted = getattr(dist_ba, "allreduce_bytes", None)
    if counted is not None:
        dist_ba.reset_allreduce_bytes()
    iters = state["cfg"]["iters"]
    done, ends = [], []
    t0 = time.perf_counter()
    while True:
        with span("solve", traced):
            out = _solve(state, len(done), keep=1)
        with span("readback", traced):
            done.append(out.cpu().numpy())
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds or (max_units and len(done) >= max_units):
            break
    n = len(done)
    failed = sum(not np.isfinite(x).all() for x in done)
    units = {"iterations": n * iters, "solves": n}
    if counted is not None:
        units["allreduce_bytes"] = counted()
    return {"metrics": {"ba_iter_ms": 1e3 * elapsed / (n * iters)},
            "attempted": n, "failed": int(failed), "solves": done,
            "units": units, "unit_s": np.diff([0.0] + ends).tolist()}


def shapes(state):
    cfg = state["cfg"]
    return {"K": state["K"], "P": state["P"], "CS": state["CS"],
            "H": cfg["input_height"], "W": cfg["input_width"],
            "ranks": state["world"]}


def plant(state, fault):
    """A fault under the timed path, planted in every rank that plays a
    part in it: the step returns its state unchanged (rank 0); half of the
    factors left out (every shard's later half); one keyframe's pose
    altered where rank 0's solve produces it (those three as the one-card
    driver plants them); one rank's system left out of the sum (the last
    rank zeroes what it all-reduces)."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r} (has {FAULTS})")
    state["fault"] = fault
    if fault in ("half", "exchange"):
        apply_fault(state, fault)
    else:
        lm.plant(state, fault)


def stop(state, log=print) -> list:
    """End the world: the other ranks write their kept solves and peaks and
    leave; then this rank leaves. Their results, rank by rank."""
    from deepfactors_tpu_torch.parallel import multihost
    from portbench import harness
    if "own_report" in state:
        harness.device_kind = state.pop("own_report")
    ranks = state.pop("ranks", None)
    if ranks is None:
        return []
    ranks.stopping = True
    _command(state, STOP)
    multihost.shutdown()
    ranks.wait(STOP_TIMEOUT_S)
    outs = [dict(np.load(ranks.out(r))) for r in range(1, state["world"])]
    ranks.close()
    for r, o in enumerate(outs, 1):
        log(f"largemap4: rank {r} peak memory {int(o['peak'])} bytes, "
            f"{len(o['solves'])} solves kept")
    return outs


def check(state, res, reference, limits, seed, log=print):
    """Every rank's window solves against rank 0's (``replica_gap``: the
    largest absolute gap of a pose or code entry), then the reference over
    ``check_solves`` of the window's solves drawn from the seed, as the
    one-card large map checks (``h_ratio``: the program's ``h_gap`` from
    the float64 solve over the float32 solve's)."""
    cfg, traffic, device = state["cfg"], state["traffic"], state["device"]
    if device.type == "cuda":
        log(f"largemap4: rank 0 peak memory "
            f"{torch.cuda.max_memory_allocated(device)} bytes")
    outs = stop(state, log)
    gap = 0.0
    mine = np.stack(res["solves"]) if res["solves"] else np.zeros((0,))
    for r, o in enumerate(outs, 1):
        theirs = o["solves"]
        if theirs.shape != mine.shape:
            gap = float("nan")
            log(f"largemap4: rank {r} kept {theirs.shape}, rank 0 "
                f"{mine.shape}")
            continue
        gap = lm._worse(gap, float(np.abs(theirs - mine).max())
                        if mine.size else 0.0)
    # free the program's state before the reference runs
    for k in ("problem", "ba"):
        state.pop(k, None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    inputs, picks = reference_inputs(state, reference, res, seed)
    state["inputs"], state["picks"], state["ref_solves"] = inputs, picks, {}
    log(f"largemap4 check: reference inputs ready, "
        f"{time.perf_counter() - t0:.2f} s")
    worst = {"replica_gap": gap}
    for n, i in enumerate(picks):
        got = torch.as_tensor(res["solves"][i], device=device)
        ref64 = lm.reference_solve(state, reference, inputs, i)
        system = reference.normal_equations(
            inputs, *ref64, state["cam"], cfg["sfm"], cfg["priors"])[::2]
        # keep the float64 system off the reference's home card
        keep = state["devices"][(n + 1) % len(state["devices"])]
        system = tuple(x.to(keep) for x in system)
        ref32 = lm.reference_solve(state, reference, inputs, i,
                                   "float32")
        noise = _gaps(reference, ref32, ref64, system)["h_gap"]
        state["ref_solves"][i] = (ref64, system, noise)
        g = _gaps(reference, (got[:, :4], got[:, 4:7], got[:, 7:]), ref64,
                  system)
        g["h_float32"] = noise
        g["h_ratio"] = g["h_gap"] / max(noise, traffic["h_floor"])
        for k, v in g.items():
            worst[k] = lm._worse(worst.get(k, 0.0), v)
        log(f"largemap4 check: solve {i}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in g.items())
            + f", {time.perf_counter() - t0:.2f} s")
    state["readings"] = worst
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}


def _gaps(reference, got, ref, system):
    """``reference.gaps`` on the device that holds the system."""
    dev = system[0].device
    mv = lambda xs: [x.to(dev) for x in xs]
    return reference.gaps(*mv(got), *mv(ref), system)


def reference_inputs(state, reference, res, seed):
    """The reference's keyframes (every one rendered, Sobel gradients,
    decoded by the reference's decoder) spread over the world's devices,
    and the solves to check."""
    from portbench.reference import net
    cfg, device, K = state["cfg"], state["device"], state["K"]
    H, W = cfg["input_height"], cfg["input_width"]
    params = state["dec_params"] or net.load_decoder_params(
        str(ROOT / cfg["weights"]), device)
    images = torch.empty((K, H, W), device=device)
    for a in range(0, K, 16):
        images[a:a + 16] = synth.render_aa(
            state["scene"], state["cam"], state["qw"][a:a + 16],
            state["tw"][a:a + 16], H, W, device=device)[0]
    grads = synth.sobel_gradients(images)
    prx0, jac = reference.decode(params, images, cfg["pyramid_levels"])
    src, dst = torch.as_tensor(_pairs(state["links"]), device=device).T
    inputs = reference.spread(reference.Inputs(images, grads, prx0, jac, src,
                                               dst), state["devices"])
    n = len(res["solves"])
    rng = np.random.default_rng(int(seed) + 1)
    m = min(n, state["traffic"]["check_solves"])
    return inputs, sorted(rng.choice(n, size=m, replace=False).tolist())


def control(state, res, reference, seed):
    """The control's readings, after ``check``: the reference in TF32 in
    the program's place, on the solves the check took, measured as the
    check measures the program."""
    worst = {}
    for i in state["picks"]:
        ref64, system, noise = state["ref_solves"][i]
        low = lm.reference_solve(state, reference, state["inputs"], i,
                                 "tf32")
        g = _gaps(reference, low, ref64, system)
        g["h_ratio"] = g["h_gap"] / max(noise, state["traffic"]["h_floor"])
        print(f"largemap4 control: solve {i}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in g.items()), file=sys.stderr)
        for k, v in g.items():
            worst[k] = lm._worse(worst.get(k, 0.0), v)
    return worst


# ---------------------------------------------------------------------------
# ranks 1..n-1
# ---------------------------------------------------------------------------

def _orphan_watch(parent: int):
    """End this rank when the process that started it is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(0.5)


def _wait_ready(d: Path) -> None:
    """Wait for rank 0's ``ready`` file (the kernels are built)."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not (d / "ready").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no ready file in {d} after "
                               f"{RANK_TIMEOUT_S:.0f} s")
        time.sleep(0.02)


def worker(argv=None) -> int:
    from deepfactors_tpu_torch.parallel import multihost

    ap = argparse.ArgumentParser(prog="largemap4 --worker")
    ap.add_argument("--worker", required=True)
    ap.add_argument("--coord", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    threading.Thread(target=_orphan_watch, args=(args.parent,),
                     daemon=True).start()
    torch.set_num_threads(1)
    spec = json.loads(Path(args.worker).read_text())
    rank, n = args.proc_id, args.nproc
    cuda = spec["device"] == "cuda"
    device = torch.device(spec["device"], rank) if cuda else \
        torch.device(spec["device"])
    log = lambda *a: print(*a, flush=True)
    since = lambda: time.time() - spec["spawned"]
    imported = since()
    _wait_ready(Path(args.worker).parent)
    ready = since()
    if cuda:
        torch.cuda.set_device(device)
    state = build(spec["cfg"], spec["traffic"], spec["seed"], device, n,
                  rank, log)
    built = since()
    join(state, args.coord, cuda)
    log(f"set-up: rank {rank}: s after its spawn: imports {imported:.2f}, "
        f"ready {ready:.2f}, built {built:.2f}, joined {since():.2f}")
    import torch.distributed as dist
    word = torch.zeros(4, dtype=torch.int64, device=device)
    kept = []
    while True:
        dist.broadcast(word, src=0, group=state["group"])
        cmd, i, fault, keep = word.tolist()
        if cmd == STOP:
            break
        if fault:
            apply_fault(state, {v: k for k, v in CODES.items()}[fault])
        out = _run(state, i).cpu().numpy()
        if keep:
            kept.append(out)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    np.savez(Path(args.worker).parent / f"rank{rank}.npz",
             solves=np.stack(kept) if kept else np.zeros((0,)),
             peak=np.int64(peak))
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(worker())
