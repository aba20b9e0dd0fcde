"""Device operations (kernels, copies, sets) a solve whose launch lies
inside the program's ``springcraft::rigid_bases`` span: the rigid-body
bases' QR (``ops/rigid.py`` ``rigid_modes_anm``, ``torch.linalg.qr``) and
the building of the modes it factors.  None where no device operation
lies inside that span."""

SPAN = "springcraft::rigid_bases"


def read(run):
    if run.trace is None or not run.work:
        return None
    count = run.trace.count(lambda op: SPAN in op.launched_under)
    return count / run.work if count else None
