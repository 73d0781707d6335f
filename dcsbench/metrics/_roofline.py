"""The table of peaks and the roofline share that every ``*.roofline``
metric reads.

Peaks of one NVIDIA H100 SXM: 3.35 TB/s of HBM, and 33.5 TOP/s of INT32
(64 INT32 lanes an SM x 132 SMs x 1.98 GHz, a multiply-add counted as
two).  A kernel's least time is the larger of its bytes over the first and
its integer operations over the second; its share is that time over the
device time the trace gives it.  Bytes count each input byte read once and
each output byte written once.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12


def least_seconds(n_bytes, n_ops):
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def share(ctx, kernels, work):
    """100 x least time / device time of the kernels named (function names)
    over the traced jobs, or None where the cell has no such work or the trace
    holds none of the kernels.  ``work``: (bytes, ops) of one job."""
    if work is None:
        return None
    seconds = ctx.kernel_seconds(kernels)
    if not seconds:
        return None
    n_bytes, n_ops = work
    return 100.0 * least_seconds(n_bytes * ctx.jobs, n_ops * ctx.jobs) \
        / seconds
