"""
Readings that set a cell's limits: the numbers its check compares, for
the program on many seeds and for a control on a few, in one process.

    python3 enm_bench/calibrate.py --workload <cell> --seeds 11,12,... \
        --requests <n> [--control tf32 --control-seeds 1,2,3] \
        [--out <file.jsonl>]

Each seed is a run of the cell capped at `n` requests (each compares a
sample of the same size as a benchmark run does); each prints one JSON
line with its readings.  The control ``tf32`` is the program with TF32
switched on in its float32 matrix products (the configurations state
float32 with TF32 off).  Benchmark runs never run a control.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _seeds(text):
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--requests", type=int, required=True)
    parser.add_argument("--control", choices=("tf32",))
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from enm_bench.harness import session, spec

    cell = spec.load_cell(args.workload)
    runs = [(seed, None) for seed in args.seeds]
    runs += [(seed, args.control) for seed in args.control_seeds]
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for seed, control in runs:
            start = time.perf_counter()
            result, readings = session.run_cell(
                cell, seed, 1e9, False, start, device=args.device,
                control=control, max_requests=args.requests)
            line = json.dumps({
                "workload": args.workload, "seed": seed, "control": control,
                "attempted": result["attempted"],
                "failed": result["failed"], "readings": readings,
                "correct_at_current_limits": result["correct"],
                "metrics": result["metrics"],
                "seconds": time.perf_counter() - start})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
