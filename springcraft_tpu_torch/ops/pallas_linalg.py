"""
The public names of the JAX package's panel-kernel module,
``springcraft_tpu/ops/pallas_linalg.py``.

They live in :mod:`.spd_linalg` (the divide-and-conquer inverse factor
with the panel kernels K3, K8 and K9) and are imported here under the
module name that callers of the JAX package import them from.  The
TPU keywords ``interpret=`` and ``batch_chunk=`` are not carried over.
"""

from .spd_linalg import (padded_size, panel_cholesky_batched,
                         panel_inverse_batched, spd_inverse_blocked,
                         spd_inverse_factor, spd_inverse_factor_parts)

__all__ = ["panel_cholesky_batched", "panel_inverse_batched",
           "spd_inverse_blocked", "spd_inverse_factor",
           "spd_inverse_factor_parts", "padded_size"]
