"""Device microseconds per solve of the dense products: the inverse
factor's node products (``ops/spd_linalg.py``) and the Grams
(``ops/rigid.py``), every device operation launched under a
``torch.matmul`` family operator and not inside the QR."""

GEMM_OPS = ("aten::matmul", "aten::mm", "aten::bmm", "aten::addmm",
            "aten::baddbmm", "aten::addbmm")
QR_OPS = ("aten::linalg_qr", "aten::geqrf", "aten::linalg_householder_product",
          "aten::orgqr")


def is_gemm(op):
    under = op.launched_under
    return any(name in GEMM_OPS for name in under) \
        and not any(name in QR_OPS for name in under)


def read(run):
    if run.trace is None or not run.work:
        return None
    seconds = run.trace.seconds(is_gemm)
    return 1e6 * seconds / run.work if seconds else None
