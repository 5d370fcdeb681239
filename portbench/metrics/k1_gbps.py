"""K1, the DIA SpMV: the bytes per second it moves over every launch in
the traced stretch, in GB/s: the bytes the launches need
(kernels.k1_bytes at each launch's value type, from the cell's own n and
band count) over their summed device time.  A rate and not a share of a
roofline: at these sizes K1's operands (4-8 MB) sit in the card's L2, so
the HBM rate does not bound it."""
from portbench import kernels

KERNEL = "dia_spmv_kernel"


def read(rec):
    if rec.trace is None or not rec.cuda:
        return None
    nbytes = busy = 0.0
    for s, t, name in rec.trace.device:
        if KERNEL not in name:
            continue
        size = 8 if "<double" in name else 4
        nbytes += kernels.k1_bytes(rec.k1["n"], rec.k1["bands"], size)
        busy += (t - s) * 1e-9
    return 1e-9 * nbytes / busy if busy > 0 else None
