"""The four-card reference against the one-card reference and against the
port's step over four gloo ranks, at a tiny size on the CPU.

- Its system over four blocks of factors equals the one-block system of
  ``reference/largemap.py``: the same float32 blocks summed in float64 in
  another order, so to float64's rounding (1e-12 of the largest entry);
  the cost, whose chunks sum in float32, to float32's (1e-6).
- Its float64 step equals the one-block reference's step to 1e-9 m and
  rad (the same solve of systems 1e-12 apart; the system is poorly
  conditioned, so not to rounding).
- The port's step over four ranks (each rank's shard from
  ``build_problem(world_size=4, rank=r)``, the system all-reduced over
  gloo) lands as near the reference as one process's step does
  (``test_portbench_reference.py``): 2% of the reference's move in
  translation and rotation, the program solving this small, poorly
  conditioned system in float32, and codes within 1e-4."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.reference import largemap as rlm
from portbench.reference import largemap4 as r4

from .tiny import tiny_problem

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
K = 5
_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from portbench.tests.test_portbench_largemap4_reference import port_step
torch.set_num_threads(1)
rendezvous, rank = sys.argv[2], int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + rendezvous,
                        world_size=4, rank=rank)
q, t, c = port_step(dist.group.WORLD, rank)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"q": q.tolist(), "t": t.tolist(), "c": c.tolist()}))
"""


def codes_at(CS):
    return 0.1 * torch.randn((K, CS), generator=torch.Generator()
                             .manual_seed(1))


def port_step(group, rank):
    """One step of the port's BA on rank ``rank``'s shard of the tiny
    problem, the system all-reduced over ``group``."""
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.parallel import dist_ba, large_map
    pr, inp, cam, pcam, sfm, priors = tiny_problem(K=K, seed=4)
    links = [(j, i) for i in range(K) for j in range(max(0, i - 2), i)]
    CS = pr.codes.shape[1]
    mine = large_map.build_problem(
        inp.images, inp.prx0, inp.jac, torch.zeros_like(inp.prx0),
        inp.grads, SE3(pr.pose_q, pr.pose_t), pr.codes, links, 4, rank)
    step = dist_ba.make_ba_step(K, CS, pcam, ds.SfmParams(**sfm),
                                group=group, **priors)
    q, t, c, _ = step(mine.pose_q, mine.pose_t, codes_at(CS), mine.fd,
                      mine.active)
    return q, t, c


@pytest.fixture(scope="module")
def problem():
    return tiny_problem(K=K, seed=4)


def test_four_blocks_sum_to_one(problem):
    pr, inp, cam, _, sfm, priors = problem
    codes = codes_at(pr.codes.shape[1])
    sp = r4.spread(inp, ["cpu"] * 4)
    assert [p.src.shape[0] for p in sp.parts] == [4, 4, 4, 2]
    H4, b4, c4 = r4.normal_equations(sp, pr.pose_q, pr.pose_t, codes, cam,
                                     sfm, priors)
    H1, b1, c1 = rlm.normal_equations(inp, pr.pose_q, pr.pose_t, codes, cam,
                                      sfm, priors)
    assert float((H4 - H1).abs().max()) <= 1e-12 * float(H1.abs().max())
    assert float((b4 - b1).abs().max()) <= 1e-12 * float(b1.abs().max())
    # a chunk's squared residuals are summed in float32 on its device, and
    # the chunks differ: the cost agrees to float32's rounding
    assert float(abs(c4 - c1)) <= 1e-6 * float(c1)
    q4, t4, k4 = r4.gn_step(sp, pr.pose_q, pr.pose_t, codes, cam, sfm,
                            priors)
    q1, t1, k1 = rlm.gn_step(inp, pr.pose_q, pr.pose_t, codes, cam, sfm,
                             priors)
    g = rlm.gaps(q4, t4, k4, q1, t1, k1)
    assert g["t_gap_m"] < 1e-9 and g["r_gap_rad"] < 1e-9, g
    assert g["code_gap"] < 1e-9, g


def test_port_four_ranks_match_the_reference(problem, tmp_path):
    pr, inp, cam, _, sfm, priors = problem
    codes = codes_at(pr.codes.shape[1])
    rendezvous = str(tmp_path / "rendezvous")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, ROOT, rendezvous,
                               str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    qr, tr, cr = r4.gn_step(r4.spread(inp, ["cpu"] * 4), pr.pose_q,
                            pr.pose_t, codes, cam, sfm, priors)
    moved = float((tr - pr.pose_t).norm(dim=-1).max())
    turned = float(rlm.rotation_gap(qr, pr.pose_q).max())
    for o in outs:
        # the replicas agree bit for bit
        assert o == outs[0]
        q, t, c = (torch.tensor(o[k]) for k in ("q", "t", "c"))
        g = rlm.gaps(q, t, c, qr, tr, cr)
        assert g["t_gap_m"] < 0.02 * moved, g
        assert g["r_gap_rad"] < 0.02 * turned, g
        assert g["code_gap"] < 1e-4, g
    assert np.isfinite(outs[0]["q"]).all()
