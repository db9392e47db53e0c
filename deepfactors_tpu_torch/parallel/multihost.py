"""Several processes, one world: ``torch.distributed`` bring-up, the
per-process factor split of distributed BA, and a launcher of rank
processes.

PyTorch port of ``deepfactors_tpu/parallel/multihost.py``. The JAX package
runs one process per host with ``jax.distributed`` and builds a global mesh
over every device; here each process is one rank of a
``torch.distributed`` world and holds one card (or the CPU). The same code
runs:

  - in one process: ``initialize()`` with no arguments and no ``torchrun``
    variables is a no-op, and ``global_group()`` is None (no collective);
  - under ``torchrun``: ``initialize()`` reads RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT (``env://``);
  - with explicit arguments: a ``tcp://host:port`` or ``file://path``
    rendezvous, as ``World`` starts its ranks. The ranks on this host are
    LOCAL_RANK of LOCAL_WORLD_SIZE where those are set; else a rank that
    names its card (``local_device_ids``) takes that card, and a rank that
    names none is taken to share one host with every other rank (rank r on
    card r modulo the count). So across hosts every rank names its card or
    sets the two variables.

Backends: ``nccl`` when the rank's device is a card, ``gloo`` on the CPU.
NCCL needs a card of its own for every rank; on fewer cards than ranks
``initialize`` raises and names ``backend="gloo"``, which runs several
ranks on one card (gloo reduces CUDA tensors through the host; of the
collectives only ``all_reduce`` and ``broadcast`` take them). No backend is
ever swapped behind the caller's back.

Per-process factor sharding: each process builds only the factor rows it
owns (``host_factor_slice``) and hands them to ``host_local_to_global``,
which puts them on its device: that is what ``dist_ba.make_ba_step``
takes per rank, and the system is summed over the group.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the device initialize() chose for this process (None: not initialised)
_DEVICE: Optional[torch.device] = None
_TIMEOUT = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               device: str = "cuda") -> None:
    """Join this process to its world and pick its device. Idempotent.

    With no ``coordinator_address`` / ``num_processes`` the world comes
    from the ``torchrun`` variables, or, without them, is this process
    alone (no process group). ``coordinator_address`` is ``host:port``,
    ``tcp://host:port`` or ``file://path`` (a file store: every rank names
    the same new file). ``device`` is ``"cuda"`` (the default; raises
    without a card) or ``"cpu"``; a rank's card is ``local_device_ids[0]``
    or else its local rank modulo the card count (the module docstring
    says which ranks are local). ``backend`` defaults to ``nccl`` on a
    card and ``gloo`` on the CPU; NCCL raises where this host has more
    ranks than cards. Every collective of the group waits at most
    ``timeout_s``."""
    global _DEVICE, _TIMEOUT
    if _DEVICE is not None:
        return
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda, but no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            _DEVICE = _pick_device(kind, 0, local_device_ids)
            return
        init = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id are given together")
        init = (coordinator_address if "://" in coordinator_address
                else "tcp://" + coordinator_address)
        world, rank = int(num_processes), int(process_id)
        if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
            local_rank = int(env["LOCAL_RANK"])
            local_world = int(env["LOCAL_WORLD_SIZE"])
        else:
            # every rank on this host, unless this one names its own card
            local_rank, local_world = rank, 1 if local_device_ids else world
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"NCCL needs a card of its own for every rank: {local_world} "
                f"ranks on this host, {cards} card(s). Pass backend='gloo' "
                f"to run several ranks on one card")
    dev = _pick_device(kind, local_rank, local_device_ids)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=_TIMEOUT, **kw)
    _DEVICE = dev


def _pick_device(kind: str, local_rank: int,
                 local_device_ids: Optional[Sequence[int]]) -> torch.device:
    if kind == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    index = (local_device_ids[0] if local_device_ids
             else local_rank % cards)
    if not 0 <= index < cards:
        raise RuntimeError(f"card {index} asked for, {cards} present")
    return torch.device("cuda", index)


def shutdown() -> None:
    """Leave the world: a ``barrier`` (so that no rank tears its end down
    while another still reduces), then ``destroy_process_group``."""
    global _DEVICE
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _DEVICE = None


def local_device() -> torch.device:
    """The device ``initialize`` chose for this process."""
    if _DEVICE is None:
        raise RuntimeError("multihost.initialize() has not run")
    return _DEVICE


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_group(n: Optional[int] = None):
    """The counterpart of ``global_mesh``: the group every collective of
    ``dist_ba`` / ``multi_seq`` / ``train_decoder`` reduces over. The whole
    world (None in a single process), or the first ``n`` ranks (a
    collective call: every rank of the world makes it)."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(f"a group of {n} ranks in a single process")
        return None
    if n is None or n == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(range(n)), timeout=_TIMEOUT)


def world_rank(group) -> tuple:
    """(world size, this process's rank) of ``group``; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def rank_rows(n: int, world: int = 1, rank: int = 0) -> slice:
    """Rank ``rank``'s contiguous block of n rows split over ``world``
    ranks (a batch's samples, the scenes of an odometry)."""
    assert n % world == 0, f"{n} rows do not split over {world} ranks"
    return slice(rank * (n // world), (rank + 1) * (n // world))


def host_factor_slice(n_factors: int) -> slice:
    """The contiguous factor range THIS process owns (factors are
    block-partitioned across processes; pad n_factors to a multiple of
    process_count first)."""
    pc, pid = process_count(), process_index()
    per = n_factors // pc
    assert per * pc == n_factors, (
        f"n_factors={n_factors} must divide process_count={pc}")
    return slice(pid * per, (pid + 1) * per)


def host_local_to_global(local_rows: tuple, device) -> tuple:
    """This process's factor rows (a NamedTuple such as
    ``dist_ba.ShardedFactorData`` of numpy arrays or tensors, leading axis
    = local factor count) as tensors on ``device``. PyTorch has no global
    array: each rank keeps its own rows, which is what
    ``dist_ba.make_ba_step`` takes per rank, and the step sums the system
    over the group."""
    return type(local_rows)(*(torch.as_tensor(x, device=device)
                              for x in local_rows))


class World:
    """``nproc`` rank processes of one world, started at once: rank r runs
    ``argv + ["--coord", "file://<fresh dir>/rendezvous", "--nproc", nproc,
    "--proc-id", r]`` (the worker flags of ``tools/multihost_demo.py``),
    with the repository on its PYTHONPATH and its output in a file. Start
    ranks this way, not by forking: a process that holds a CUDA context
    must not fork. ``World(argv, n).wait(timeout_s)`` runs a world to its
    end."""

    def __init__(self, argv: Sequence[str], nproc: int, env=None):
        self.nproc = nproc
        self._tmp = tempfile.TemporaryDirectory(prefix="df_world_")
        coord = "file://" + os.path.join(self._tmp.name, "rendezvous")
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        self._logs, self._procs = [], []
        try:
            for r in range(nproc):
                log = open(os.path.join(self._tmp.name, f"rank{r}.log"), "w+")
                self._logs.append(log)
                self._procs.append(subprocess.Popen(
                    list(argv) + ["--coord", coord, "--nproc", str(nproc),
                                  "--proc-id", str(r)],
                    stdout=log, stderr=subprocess.STDOUT,
                    cwd=_REPO, env=env))
        except BaseException:
            self.close()
            raise

    def wait(self, timeout_s: float = 600.0) -> list:
        """Each rank's (return code, output). A rank that fails ends the
        others at once (they would wait in a collective until their group's
        timeout); a world still running after ``timeout_s`` is killed and
        ``TimeoutError`` raised. Every process is ended on the way out."""
        deadline = time.monotonic() + timeout_s
        timed_out = False
        try:
            while any(p.poll() is None for p in self._procs):
                if any(p.returncode not in (None, 0) for p in self._procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            outs = self.close()
        if timed_out:
            raise TimeoutError(
                f"a world of {self.nproc} ranks ran past {timeout_s} s:\n"
                + "\n".join(f"--- rank {r} ---\n{o}"
                            for r, o in enumerate(outs)))
        return [(p.returncode, o) for p, o in zip(self._procs, outs)]

    def close(self) -> list:
        """Kill every rank still running, wait for all, read their outputs
        and remove the rendezvous directory."""
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()
        outs = []
        for log in self._logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        self._logs = []
        self._tmp.cleanup()
        return outs
