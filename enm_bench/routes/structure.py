"""
Single-structure requests: one client in a closed loop sends one
structure a request and waits for its lowest modes.  A request takes the
next of a pool of ``pool`` conformers, made from the seed in set-up and
held on the device (each has a Hessian of its own), and calls the
program's public names in turn on its float32 coordinates:

    h = ops.pallas_kernels.hessian_pallas(coord, params)
    vals, vecs = lowest_modes_anm(h, coord, modes + mode_buffer, **engine)
    theta, vecs, _ = refine_modes_f64(coord, params, vecs, layout="xyz")

with the configuration's ``engine`` (``method``, ``engine``,
``n_iter``, ``oversample``).  It is timed from the call to a synchronize of the refined
outputs; one finished structure is one solve.

Controls (readings that set the limits, never in a benchmark run):
``tf32``, TF32 on in the program's float32 matrix products; ``norefine``,
the raw float32 modes with the refinement left out.

The answers of the structures that enter the seeded sample are kept on
the device: the ``modes`` lowest eigenvalues and their mode-sum MSF.
Once the window has closed they are judged against the float64 reference
module that the traffic names, each by ``max |program - reference| / max
|reference|`` over a structure, the worst structure of the sample; the
reference's seconds a structure go to standard error.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch

from ..harness import inputs, program
from ..harness.sample import Sample
from ..reference.springs import Network
from ..reference.structure import mode_msf

CONTROLS = ("tf32", "norefine")


class Route:
    def __init__(self, cell, seed, device, control, tracer):
        self.cell, self.seed, self.device = cell, seed, device
        self.control, self.tracer = control, tracer
        self.traced_sweeps = 0

    def setup(self):
        cfg, traffic = self.cell.config, self.cell.traffic
        if self.control not in (None,) + CONTROLS:
            raise ValueError(f"no control {self.control!r} for structures")
        self.sct = program.load()
        if self.control == "tf32":
            program.set_tf32(True)
        pool = int(traffic["pool"])
        self.structures = inputs.conformers(cfg["structure"], self.seed,
                                            pool)
        self.host = self.structures.coords
        self.n = self.host.shape[-2]
        self.pool = torch.as_tensor(self.host, device=self.device)
        self.params = program.force_field(self.sct, cfg, self.structures)
        self.bins = int(self.params.n_bins)
        self.modes = int(cfg["modes"])
        self.k = self.modes + int(cfg["mode_buffer"])
        engine = cfg["engine"]
        self.engine = {key: engine[key] for key in ("method", "engine",
                                                    "n_iter", "oversample")}
        self.assemble = importlib.import_module(
            program.PACKAGE + ".ops.pallas_kernels").hessian_pallas
        self.modes_module = importlib.import_module(
            program.PACKAGE + ".ops.modes")
        self.sample = Sample(traffic["sample"], self.seed)
        self.kept = []

    def _sweeps(self):
        """The program's count of shift-invert iterations run, or None
        where it keeps none."""
        solver = getattr(self.modes_module, "lowest_modes_shift_invert", None)
        return getattr(solver, "sweeps", None)

    def _solve(self, i):
        coord = self.pool[i % len(self.pool)]
        h = self.assemble(coord, self.params)
        vals, vecs = self.sct.lowest_modes_anm(h, coord, self.k,
                                               **self.engine)
        del h
        if self.control == "norefine":
            return vals, vecs
        theta, refined, _ = self.sct.refine_modes_f64(coord, self.params,
                                                      vecs, layout="xyz")
        return theta, refined

    def warmup(self):
        for i in range(int(self.cell.traffic["warmup_calls"])):
            self._solve(i)
        program.sync(self.device)

    def request(self, i):
        before = self._sweeps()
        with self.tracer.span("call"):
            values, vectors = self._solve(i)
            program.sync(self.device)
        after = self._sweeps()
        if self.tracer.active and before is not None and after is not None:
            self.traced_sweeps += after - before
        take, keys = self.sample.offer(1)
        if take.size:
            values = values[:self.modes]
            self.kept.append({
                "key": float(keys[0]), "slot": i % len(self.pool),
                "eig_values": values.to(torch.float64),
                "msf": mode_msf(values.to(torch.float64),
                                vectors[:self.modes].to(torch.float64).T)})
            if len(self.kept) > 4 * self.sample.size:
                self._prune()
        return 1

    def _prune(self):
        limit = self.sample.threshold()
        self.kept = [b for b in self.kept if b["key"] <= limit]

    def end_to_end(self, elapsed, work):
        return {"solves_per_s": work / elapsed}

    def shapes(self):
        """``n`` atoms, ``k`` modes solved, ``block`` the width of the
        shift-invert block (``k`` and the configuration's ``oversample``),
        ``bins`` the force field's distance bins, ``sweeps`` the
        iterations the traced requests ran (None where the program counts
        none)."""
        return {"n": self.n, "k": self.k,
                "block": self.k + int(self.engine["oversample"]),
                "bins": self.bins,
                "sweeps": self.traced_sweeps if self._sweeps() is not None
                else None}

    def release(self):
        self._prune()
        del self.pool, self.params
        if self.control == "tf32":
            program.set_tf32(False)

    def check(self):
        """The worst relative error of each compared output over the
        sample (inf for a non-finite one)."""
        compare = list(self.cell.traffic["compare"])
        if not self.kept:
            return {key: float("inf") for key in compare}
        kept = sorted(self.kept, key=lambda b: b["key"])[:self.sample.size]
        self.kept = []
        reference = importlib.import_module(
            f"enm_bench.reference.{self.cell.traffic['reference']}")
        s = self.structures
        network = Network(self.cell.config["force_field"], s.res_name,
                          s.chain_id, s.res_id)
        ref = {}
        for slot in sorted({b["slot"] for b in kept}):
            start = time.perf_counter()
            coords = torch.as_tensor(self.host[slot][None],
                                     device=self.device)
            out = reference.observables(coords, network, compare,
                                        {"modes": self.modes})
            ref[slot] = {key: value[0] for key, value in out.items()}
            program.sync(self.device)
            print(f"enm_bench: reference of structure {slot}: "
                  f"{time.perf_counter() - start:.1f} s", file=sys.stderr)
        worst = {}
        for key in compare:
            errs = []
            for b in kept:
                r = ref[b["slot"]][key]
                err = float((b[key] - r).abs().max() / r.abs().max())
                errs.append(err if np.isfinite(err) else float("inf"))
            worst[key] = max(errs)
        return worst
