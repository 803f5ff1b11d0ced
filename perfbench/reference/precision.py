"""The control's lower precision: the reference's products with weights
taken in the precision next below the one a configuration states (LOWER:
fp8 e4m3 below bfloat16, bfloat16 below float32). For fp8 a weight is
rounded with one scale an output channel and an activation with one scale a
row, each scale the slice's largest magnitude over e4m3's largest, as fp8
inference rounds them; the product of the rounded values is taken in
float32. Attention's own products stay in float32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
LOWER = {"float32": "bfloat16", "bfloat16": "fp8"}


def rounded(t: torch.Tensor, kind: str) -> torch.Tensor:
    """t rounded to `kind` ("fp8": e4m3 along its last axis, one scale a
    row; "bfloat16"), back in float32."""
    if kind == "bfloat16":
        return t.to(torch.bfloat16).float()
    scale = t.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class LowPrecision(dict):
    """A state dict whose products (``matmul``) run in a lower precision."""

    def __init__(self, weights: dict, kind: str):
        super().__init__(weights)
        self.kind = kind

    def mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return rounded(x, self.kind) @ rounded(self[name], self.kind).T


def matmul(W, x: torch.Tensor, name: str) -> torch.Tensor:
    """x @ W[name]^T, in the lower precision where W is a LowPrecision."""
    return W.mm(x, name) if isinstance(W, LowPrecision) else x @ W[name].T
