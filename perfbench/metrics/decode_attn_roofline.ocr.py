"""K3's share of its roofline: the least time of the decode attention that
the traced calls' lines need (their cache bytes read once, over the
memory bandwidth) over K3's device time there, in percent."""

from perfbench import devtrace, peaks


def read(run):
    t = run.trace.seconds(lambda n: devtrace.kind_of(n) == "K3 gqa_decode") if run.trace else 0.0
    if not t or "k3_bytes" not in run.work:
        return None
    return 100.0 * peaks.bound_s(run.work["k3_flops"], run.work["k3_bytes"]) / t
