"""
Where the time of the matrix-free paths goes on the card.

Drives ``lowest_modes_matfree``, ``dcc_rows_matfree`` (8 sites, 24 CG
columns) and ``lowest_modes_matfree_gnm`` at n = 30,000 as
``chip_smoke.py`` does (its atoms, settings and tolerances), under the
invariant 13 A field and sdENM, each once to warm up and once under
``torch.profiler``; prints each path's wall time, the device's busy share
(the union of kernel intervals over the wall), and the kernels that take
the most device time, grouped by name, with their launches and their
share of all kernel time.  Then times the set-up stages of one solver call (host clock
to a synchronize): the Gershgorin bound and the block-Jacobi diagonal by
the plain O(n^2) row-blocked passes on the original order (the route off
the kernels), the host Morton sort and tile lists, the pair-CSR build,
and the same bound and diagonal off the pair CSR (what the solvers run
on the kernel route).  GPU only; traces go to ``build/profile/``.

Usage:  python3 tools/profile_matfree.py [--top 8]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.realpath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import matfree  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.realpath(__file__)), "..",
                   "build", "profile")


def busy_ms(events):
    """Union of the device intervals of the kernels in `events`, ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA")
    total, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def paths(params, tabulated):
    n = cs.N_MATFREE
    coord = cs.matfree_coord(n)
    n_outer, tol = (cs.TABULATED_OUTER, cs.TABULATED_TOL) if tabulated \
        else (10, cs.MATFREE_TOL)
    sites = np.linspace(0, n - 1, 42).astype(np.int64)[::5][:8]
    return {
        "modes": lambda: sct.lowest_modes_matfree(
            coord, params, cs.MATFREE_MODES, degree=96, n_outer=n_outer,
            tol=tol),
        "dcc_rows": lambda: sct.dcc_rows_matfree(coord, params, sites,
                                                 norm=False),
        "gnm_modes": lambda: sct.lowest_modes_matfree_gnm(
            coord, params, cs.GNM_MATFREE_MODES, degree=96,
            n_outer=n_outer, tol=cs.GNM_MATFREE_TOL),
    }


def profile_path(label, fn, top):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(OUT, f"matfree_{label}.json"))
    busy = busy_ms(prof.events())
    # the device's own events (kernels, copies), not the host operators
    # that launched them, which would count the same time twice
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"),
                  key=lambda e: -e.device_time_total)
    device = sum(e.device_time_total for e in rows) / 1e3
    print(f"{label}: wall {wall:.1f} ms (profiled), device busy "
          f"{busy:.1f} ms ({busy / wall:.1%})", flush=True)
    for e in rows[:top]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms "
              f"({e.device_time_total / 1e3 / device:6.1%} of kernel time) "
              f"{e.count:6d} x  {e.key[:90]}", flush=True)


def setup_stages(params):
    n = cs.N_MATFREE
    coord = torch.as_tensor(cs.matfree_coord(n), device="cuda")
    host = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host[name] = (time.perf_counter() - t0) * 1e3
        return out

    timed("hessian_degree_bound (plain O(n^2))",
          lambda: matfree.hessian_degree_bound(coord, params))
    timed("hessian_diag_blocks (plain O(n^2))",
          lambda: matfree.hessian_diag_blocks(coord, params))
    setup = timed("_sparse_setup without the build (host sort, tile lists)",
                  lambda: matfree._sparse_setup(coord, params, None, 256,
                                                False))
    pairs = timed("pair_csr build",
                  lambda: matfree.pair_csr(setup.coord, setup.params,
                                           setup.csr, 256))
    # what the solvers run on the kernel route instead of the O(n^2) passes
    args = (setup.coord, setup.params, pairs)
    timed("Gershgorin bound off the pair CSR",
          lambda: matfree._pair_degree_bound(*args, None, setup.csr.ids))
    timed("diagonal blocks off the pair CSR",
          lambda: matfree._pair_diag_blocks(*args, setup.csr.ids))
    print("  set-up stages, ms (host clock to a synchronize): "
          + "; ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--top", type=int, default=8)
    args = parser.parse_args()
    os.makedirs(OUT, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for family, params, tabulated in (
            ("invariant", sct.invariant_params(cs.MATFREE_CUTOFF), False),
            ("sdENM", cs.sd_enm_compact(cs.N_MATFREE), True)):
        print(f"{family}, n = {cs.N_MATFREE}:", flush=True)
        for name, fn in paths(params, tabulated).items():
            profile_path(f"{name}_{family}", fn, args.top)
        setup_stages(params)


if __name__ == "__main__":
    main()
