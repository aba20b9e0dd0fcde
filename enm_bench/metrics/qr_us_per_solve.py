"""Device microseconds per solve of the rigid-body bases' QR
(``ops/rigid.py`` ``rigid_modes_anm``, ``torch.linalg.qr``): every device
operation launched under ``aten::linalg_qr``."""

QR_OPS = ("aten::linalg_qr", "aten::geqrf", "aten::linalg_householder_product",
          "aten::orgqr")


def under_qr(op):
    return any(name in QR_OPS for name in op.launched_under)


def read(run):
    if run.trace is None or not run.work:
        return None
    seconds = run.trace.seconds(under_qr)
    return 1e6 * seconds / run.work if seconds else None
