"""The expert GEMMs' share of their roofline: the least time of the sparse
layers' grouped GEMMs that the traced calls needed (counts/lfm2.moe_work:
the operations of every token-expert row the program computed, and the
bytes of each expert its layer calls hit, read once a call, and of the
rows' activations) over the device time of the kernels that ran them, in
percent."""

from perfbench import peaks

# a substring of the name of the kernel that torch._grouped_mm launches for
# the sparse layers' GEMMs (ops/moe.py): CUTLASS's grouped problem shape,
# which no other kernel of the run has
EXPERT_GEMM = "GroupProblemShape"


def read(run):
    t = run.trace.seconds(lambda n: EXPERT_GEMM in n) if run.trace else 0.0
    if not t or "moe_flops" not in run.work:
        return None
    return 100.0 * peaks.bound_s(run.work["moe_flops"], run.work["moe_bytes"]) / t
