"""Each cell's control comes out not correct.

The configurations state float32 with TF32 off.  So the control is the
program with TF32 on in its float32 matrix products (TF32 exists only on
the card: the test is marked ``cuda`` and skips without one).  The
readings at each cell's own size are in ``PERF.md``; here the sizes are
ones a test run holds.
"""

from __future__ import annotations

import copy

import pytest
import torch

from enm_bench.harness import session, spec
from enm_bench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (TF32 is a CUDA mode)")
    return "cuda"


def _card_cell(name):
    c = copy.deepcopy(spec.load_cell(name))
    c.config["conformers_per_call"] = 256
    c.traffic.update(pool=2, sample=64)
    return c


def _run_on_card(c, control, device):
    import time

    return session.run_cell(c, tiny.SEED, 1e9, False, time.perf_counter(),
                            device=device, control=control, max_requests=2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_tf32_control_fails_on_the_card(name, card):
    c = _card_cell(name)
    sound, _ = _run_on_card(c, None, card)
    control, readings = _run_on_card(c, "tf32", card)
    assert sound["correct"] is True
    assert control["correct"] is False, readings

