"""K1's and K2's share of their roofline: the least time of the encoder's
segmented attention and the decoder's causal prefill attention that the
traced calls' lines need, over the two kernels' device time, in percent."""

from perfbench import devtrace, peaks

KINDS = ("K1 segmented_block_attention", "K2 causal_flash_attention")


def read(run):
    t = run.trace.seconds(lambda n: devtrace.kind_of(n) in KINDS) if run.trace else 0.0
    if not t or "k1_flops" not in run.work:
        return None
    w = run.work
    return 100.0 * (peaks.bound_s(w["k1_flops"], w["k1_bytes"]) + peaks.bound_s(w["k2_flops"], w["k2_bytes"])) / t
