"""
Run one cell of the benchmark once and print its result line.

    python3 enm_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``springcraft_tpu_torch``), on a machine with the CUDA cards
the cell asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
against the reference beside its limit, also printed as the last lines of
standard error).  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.  Without the cards, the
program or a clean process (no JAX), it exits non-zero and prints no
result.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _process_start():
    """The process's start on the ``time.perf_counter`` clock (from
    ``/proc``), or the moment this script began where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return _STARTED
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return min(_STARTED, time.perf_counter() - age)


def _card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = _process_start()

    if not (ROOT / "springcraft_tpu_torch" / "__init__.py").is_file():
        print(f"enm_bench: the program springcraft_tpu_torch is not in "
              f"{ROOT}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))

    import torch

    from enm_bench.harness import program, session, spec

    cell = spec.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"enm_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 2
    # The program builds its kernels once a checkout, with nvcc, into
    # build/kernels/ inside it.  That build is part of the first run's
    # setup_s (a run that compiles counts its compilation), and is
    # reported apart here.
    build = importlib.import_module(program.PACKAGE + "._build")
    if not build.library_path().exists():
        start = time.perf_counter()
        build.load()
        print(f"enm_bench: first build of the kernels in this checkout: "
              f"{time.perf_counter() - start:.3f} s, inside setup_s",
              file=sys.stderr)
    try:
        result, _ = session.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), started)
    except session.ForbiddenModules as exc:
        print(f"enm_bench: {exc}", file=sys.stderr)
        return 4
    print(f"enm_bench: {args.workload} seed {args.seed} on "
          f"{_card_line()}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
