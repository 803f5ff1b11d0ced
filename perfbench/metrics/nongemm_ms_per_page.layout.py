"""Device milliseconds a page in copy, memset, index, cast and elementwise
kernels (devtrace.NON_GEMM_KINDS), over the traced calls."""

from perfbench import devtrace


def read(run):
    if run.trace is None or not run.traced_pages:
        return None
    return 1e3 * run.trace.seconds(lambda n: devtrace.kind_of(n) in devtrace.NON_GEMM_KINDS) / run.traced_pages
