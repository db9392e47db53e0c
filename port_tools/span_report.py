"""The program's spans in one run of a benchmark cell, beside the harness's
own reading of the same run.

    python3 port_tools/span_report.py --workload <cell> --seed <n> \
        --seconds <s> [--timing 1] [--json PATH]

Runs the cell as ``portbench/run.py`` does, in this process, from the root
of the checkout the script sits in, on the card (``cuda:0``). Without
``--timing`` the run is the traced one (``--trace 1``): besides the result
line's numbers it prints the idle seconds between the window's device
operations by the innermost program span open on the host when each gap
opened (``<none>``: under no program span, such as the driver's feed or
the harness's readback), next to the harness's own breakdown (its
``solve``, ``step`` and ``readback`` spans), and the summed stream time of
the program's spans a unit against the traced window a unit. With
``--timing 1`` the run is the measured one (``--trace 0``) with the
operator's tracer on (``utils.timing.enable_timing``), no profiler: what
the tracer costs the end-to-end metrics.

The last line of standard output is one JSON object; ``--json`` also
writes it to PATH.
"""
import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, spans  # noqa: E402


def report(trace, units: dict) -> dict:
    """Idle by innermost program span and stream time a unit of the
    program's spans over a finished traced run."""
    recs = spans.program_spans() or []
    unit = "iterations" if "iterations" in units else "steps"
    n = units[unit]
    idle = spans.idle_by_span(trace.ops, recs)
    names = sorted({r.name for r in recs})
    stream = {k: spans.stream_ms(recs, k, n) for k in names}
    return {"unit": unit, "units": n,
            "window_ms_per_unit": 1e3 * trace.window_s / n,
            "busy_ms_per_unit": 1e3 * trace.busy_s / n,
            "stream_ms_per_unit": stream,
            "stream_sum_ms_per_unit": sum(v for v in stream.values()
                                          if v is not None),
            "idle_s_by_program_span": {
                (k if k is not None else "<none>"): v / 1e9
                for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
            "idle_s_total": sum(idle.values()) / 1e9,
            "harness_idle_gaps": dict(trace.idle_gaps),
            "spans": len(recs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_tools/span_report.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--timing", type=int, choices=(0, 1), default=0)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch
    from deepfactors_tpu_torch.utils import timing
    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.find_cell(harness.load_manifest(), args.workload)
    traced = not args.timing
    ctxs = []
    make = harness.MetricContext
    harness.MetricContext = lambda *a: ctxs.append(make(*a)) or ctxs[-1]
    timing.reset_timing()
    timing.enable_timing(bool(args.timing))
    try:
        out = harness.run_cell(cell, args.seed, args.seconds, traced,
                               torch.device("cuda", 0), T0)
    finally:
        timing.enable_timing(False)
        harness.MetricContext = make
    line = {"workload": cell.name, "seed": args.seed,
            "timing": args.timing, "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "device": out["device"]}
    if traced:
        line["report"] = report(ctxs[0].trace, ctxs[0].units)
        line["breakdown"] = out["breakdown"]
    for k, v in line.get("report", {}).items():
        print(f"{k}: {v}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f, indent=1)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
