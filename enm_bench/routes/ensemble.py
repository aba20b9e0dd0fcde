"""
Ensemble requests: one client in a closed loop calls the program's
ensemble entry point (the traffic's ``entry``) on one call's conformers
with the configuration's engine options that the entry takes and the
traffic's options, and waits for the outputs.  A call is timed from the
call to a synchronize of its outputs; every conformer of a finished call
is one solve.

Inputs: a pool of ``pool`` calls' conformers made from the seed in
set-up and moved to the device, taken in turn.  After each call the
outputs of the conformers that enter the seeded sample are kept on the
device; once the window has closed they are judged against the
float64 reference module that the traffic names (``reference``, a
module of ``enm_bench/reference/``), each output named in the traffic's
``compare`` by ``max |program - reference| / max |reference|`` over a
conformer, the worst conformer of the sample.
"""

from __future__ import annotations

import importlib
import inspect
import statistics
import time

import numpy as np
import torch

from ..harness import inputs, program
from ..harness.sample import Sample
from ..reference.springs import Network

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Route:
    def __init__(self, cell, seed, device, control, tracer):
        self.cell, self.seed, self.device = cell, seed, device
        self.control, self.tracer = control, tracer
        self.latencies = []

    def setup(self):
        cfg, traffic = self.cell.config, self.cell.traffic
        self.sct = program.load()
        if self.control == "tf32":
            program.set_tf32(True)
        elif self.control is not None:
            raise ValueError(f"no control {self.control!r} for ensembles")
        self.batch = int(cfg["conformers_per_call"])
        pool = int(traffic["pool"])
        self.structures = inputs.conformers(cfg["structure"], self.seed,
                                            pool * self.batch)
        self.n = self.structures.coords.shape[-2]
        self.host = self.structures.coords.reshape(pool, self.batch, self.n,
                                                   3)
        self.pool = torch.as_tensor(self.host, device=self.device)
        self.params = program.force_field(self.sct, cfg, self.structures)
        self.entry = getattr(self.sct, traffic["entry"])
        takes = inspect.signature(self.entry).parameters
        engine = {k: v for k, v in cfg["engine"].items() if k in takes}
        self.options = dict(engine, **traffic["options"],
                            dtype=_DTYPES[cfg["dtype"]])
        self.compare = list(traffic["compare"])
        self.sample = Sample(traffic["sample"], self.seed)
        self.kept = []

    def _call(self, i):
        return self.entry(self.pool[i % len(self.pool)], self.params,
                          **self.options)

    def warmup(self):
        for i in range(int(self.cell.traffic["warmup_calls"])):
            self._call(i)
        program.sync(self.device)

    def request(self, i):
        start = time.perf_counter()
        with self.tracer.span("call"):
            out = self._call(i)
            program.sync(self.device)
        self.latencies.append(time.perf_counter() - start)
        take, keys = self.sample.offer(self.batch)
        if take.size:
            idx = torch.as_tensor(take, device=self.device)
            self.kept.append({
                "keys": keys, "slot": np.full(take.size, i % len(self.pool)),
                "conf": take,
                "out": {k: out[k].index_select(0, idx) for k in self.compare}})
            if sum(b["keys"].size for b in self.kept) > 4 * self.sample.size:
                self._prune()
        return self.batch

    def _prune(self):
        limit = self.sample.threshold()
        kept = []
        for block in self.kept:
            mask = block["keys"] <= limit
            if mask.all():
                kept.append(block)
            elif mask.any():
                idx = torch.as_tensor(np.flatnonzero(mask),
                                      device=self.device)
                kept.append({"keys": block["keys"][mask],
                             "slot": block["slot"][mask],
                             "conf": block["conf"][mask],
                             "out": {k: v.index_select(0, idx)
                                     for k, v in block["out"].items()}})
        self.kept = kept

    def end_to_end(self, elapsed, work):
        lat = self.latencies
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] \
            if len(lat) > 1 else lat[0]
        return {"solves_per_s": work / elapsed, "call_p95_ms": 1e3 * p95}

    def shapes(self):
        engine = self.cell.config["engine"]
        return {"batch": self.batch, "n": self.n,
                "chunk": int(engine["chunk"])}

    def release(self):
        self._prune()
        del self.pool, self.params
        if self.control == "tf32":
            program.set_tf32(False)

    def check(self):
        """The worst relative error of each compared output over the
        sample (inf for a non-finite one)."""
        if not self.kept:
            return {key: float("inf") for key in self.compare}
        keys = np.concatenate([b["keys"] for b in self.kept])
        order = np.argsort(keys)[:self.sample.size]
        slots = np.concatenate([b["slot"] for b in self.kept])[order]
        confs = np.concatenate([b["conf"] for b in self.kept])[order]
        pos = torch.as_tensor(order, device=self.device)
        got = {k: torch.cat([b["out"][k] for b in self.kept]).index_select(
            0, pos) for k in self.compare}
        self.kept = []
        coords = torch.as_tensor(self.host[slots, confs], device=self.device)
        traffic, s = self.cell.traffic, self.structures
        reference = importlib.import_module(
            f"enm_bench.reference.{traffic['reference']}")
        network = Network(self.cell.config["force_field"], s.res_name,
                          s.chain_id, s.res_id)
        ref = reference.observables(coords, network, self.compare,
                                    traffic["options"])
        worst = {}
        for key in self.compare:
            g = got[key].to(torch.float64).flatten(1)
            r = ref[key].flatten(1)
            err = (g - r).abs().amax(dim=1) / r.abs().amax(dim=1)
            err = torch.where(torch.isfinite(err), err,
                              torch.full_like(err, float("inf")))
            worst[key] = float(err.max())
        return worst
