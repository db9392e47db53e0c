"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, the program's numbers against the reference (a
set-up, a short window at the cell's size and the check), the control's
numbers (the reference in the next lower precision in the program's
place, against the reference), and with ``--faults`` each fault that the
driver can plant under the timed path.

    python3 portbench/calibrate.py --workload largemap.k128 \
        --seeds 11,12,13 --seconds 3 [--control] [--faults unchanged,half] \
        [--check-solves N]

Prints one JSON line a reading: {"seed", "kind", "readings"}.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--check-solves", type=int, default=None,
                    help="check this many of the window's solves (largemap)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_manifest(), args.workload)
    if args.check_solves:
        cell = cell._replace(traffic=dict(cell.traffic,
                                          check_solves=args.check_solves))
    driver = harness.load_module("drivers", cell.config_name)
    ref = harness.load_module("reference", cell.config_name)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]

    def emit(seed, kind, readings, t):
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                          "seconds": round(time.perf_counter() - t, 2),
                          "readings": readings}), flush=True)

    for seed in seeds:
        for kind in ["program"] + [f"fault:{f}" for f in faults]:
            t = time.perf_counter()
            state = driver.setup(cell.config, cell.traffic, seed, dev)
            if kind != "program":
                driver.plant(state, kind.split(":")[1])
            res = driver.window(state, args.seconds)
            checks = driver.check(state, res, ref, cell.traffic["limits"],
                                  seed)
            emit(seed, kind, state.get("readings") or
                 {k: c["value"] for k, c in checks.items()}, t)
            if kind == "program" and args.control:
                t = time.perf_counter()
                emit(seed, "control", driver.control(state, res, ref, seed), t)
            del state, res
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
