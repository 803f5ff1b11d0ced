"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity), at its full power limit of 700 W."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the bf16 tensor-core peak and the bytes over the memory bandwidth."""
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
