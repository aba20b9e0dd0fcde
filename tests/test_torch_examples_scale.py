"""
Four of the longer port examples (``examples_torch/``) against the JAX
package's on the CPU, as ``tests/test_torch_examples.py`` holds the
others (split so that the two files run on two workers): the conformer
ensemble, ``mega_assembly 343``, ``matrix_free_modes 512`` and
``stochastic_observables 216``.
"""

import pytest

pytest.importorskip("torch")

from .test_torch_examples import check_pair, load_smoke  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


@pytest.mark.parametrize("script", ["ensemble_nma",
                                    "mega_assembly", "matrix_free_modes",
                                    "stochastic_observables"])
def test_example_matches_jax(smoke, script, tmp_path, monkeypatch):
    check_pair(smoke, script, tmp_path, monkeypatch)
