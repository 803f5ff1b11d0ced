"""The sparse-expert layer's four kernels (csrc/moe.cu, through ops/moe.py)
against the plain path on the card, in bf16 at LFM2-8B-A1B's widths (32
experts of 1792 over 2048, top-4), at a decode step's 129 tokens and at a
128 x 128 prefill wave with the first 90 positions of each row valid.

Each kernel is held to its plain function on the same inputs: the route's
choices (a choice may differ only at a near tie of the biased scores, the
logits being summed in another order than cuBLAS's), the permute's offsets,
row places, sorted rows and counters exactly, SwiGLU within its one
rounding against the plain version's two, the combine within one bf16 unit
in the last place; then the whole layer against the plain path, twice bit
for bit, and replayed from a CUDA graph bit for bit.

The routing data lie on a grid (x in steps of 2^-7, the router in steps of
2^-14) on which every fp32 partial sum of a logit is exact, so both paths
see the same logits and near ties are rare.

Skips where there is no CUDA device. On the card (the tests' conftest.py
imports JAX, which that machine lacks):

    python -m pytest --noconftest tests/test_torch_moe_kernels.py -q
"""

import numpy as np
import pytest
import torch

from surya_tpu_torch.common import graphs
from surya_tpu_torch.ops import moe

E, H, INTER, K = 32, 2048, 1792, 4
SHAPES = {"decode, 129 tokens": (129, None), "prefill, 128 x 128, 90 valid": (128 * 128, 90)}
NEAR_TIE = 1e-5  # biased scores closer than this may be chosen either way

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def layer_inputs(dev, T, n_valid):
    """x, router, bias, w13, w2 (bf16) and valid of a case."""
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.integers(-127, 128, (T, H), dtype=np.int16)).to(dev, torch.float32) * 2.0**-7
    gate = torch.from_numpy(rng.integers(-63, 64, (E, H), dtype=np.int16)).to(dev, torch.float32) * 2.0**-14
    bias = torch.from_numpy(rng.integers(-20, 21, E, dtype=np.int16)).to(dev, torch.float32) * 2.0**-10
    gen = torch.Generator(device=dev).manual_seed(T)
    w13 = torch.randn(E, 2 * INTER, H, generator=gen, device=dev) * H**-0.5
    w2 = torch.randn(E, H, INTER, generator=gen, device=dev) * INTER**-0.5
    valid = None if n_valid is None else torch.arange(T, device=dev) % 128 < n_valid
    bf = torch.bfloat16
    return x.to(bf), gate.to(bf), bias.to(bf), w13.to(bf), w2.to(bf), valid


def flipped(x, gate, bias, chosen_k, chosen_p, valid):
    """Tokens whose kernel choices differ from the plain ones; each must be
    a near tie of the plain path's biased scores."""
    differ = (chosen_k.long() != chosen_p).any(1)
    if valid is not None:
        differ &= valid
    if differ.any():
        keys = torch.sigmoid(x.float() @ gate.float().T) + bias.float()
        mine = keys.gather(1, chosen_k.long().clamp(max=E - 1)).sort(-1).values
        theirs = keys.gather(1, chosen_p.clamp(max=E - 1)).sort(-1).values
        assert ((mine - theirs)[differ].abs() < NEAR_TIE).all(), "a choice differs away from a near tie"
    return differ


@pytest.mark.parametrize("shape", SHAPES)
def test_route_kernel_matches_route(dev, shape):
    x, gate, bias, w13, w2, valid = layer_inputs(dev, *SHAPES[shape])
    chosen, weights, hist = moe.route_kernel(x, gate, bias, True, 1.0, valid)
    chosen_p, weights_p = moe.route(x, gate, bias, K, True, 1.0, valid)
    differ = flipped(x, gate, bias, chosen, chosen_p, valid)
    assert int(differ.sum()) <= 2
    ok = ~differ if valid is None else ~differ & valid
    assert (weights - weights_p)[ok].abs().max() < 1e-6
    if valid is not None:
        assert bool((chosen[~valid] == E).all())
    # each block of 8 tokens' rows by expert
    T = x.shape[0]
    blocks = torch.arange(T * K, device=dev) // (8 * K)
    real = chosen.reshape(-1) < E
    want = torch.zeros(hist.shape, dtype=torch.int64, device=dev)
    want.index_put_((blocks[real], chosen.reshape(-1)[real].long()), torch.ones(int(real.sum()), dtype=torch.int64,
                                                                                  device=dev), accumulate=True)
    assert torch.equal(hist.long(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_permute_kernel_matches_permute(dev, shape):
    x, gate, bias, w13, w2, valid = layer_inputs(dev, *SHAPES[shape])
    chosen, _, hist = moe.route_kernel(x, gate, bias, True, 1.0, valid)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    rows, offs, inverse = moe.permute_kernel(x, chosen, hist, counts)
    counts_p = torch.zeros(3, dtype=torch.int64, device=dev)
    rows_p, offs_p, inverse_p = moe.permute(x, chosen.long(), E, counts_p)
    total = int(offs_p[-1])
    assert torch.equal(offs, offs_p)
    assert torch.equal(counts, counts_p)
    real = chosen.reshape(-1) < E
    assert torch.equal(inverse[real].long(), inverse_p[real])
    assert bool((inverse[~real] == -1).all())
    assert torch.equal(rows[:total], rows_p[:total])


@pytest.mark.parametrize("shape", SHAPES)
def test_swiglu_and_combine_kernels_match_their_plain_versions(dev, shape):
    x, gate, bias, w13, w2, valid = layer_inputs(dev, *SHAPES[shape])
    chosen, weights, hist = moe.route_kernel(x, gate, bias, True, 1.0, valid)
    rows, offs, inverse = moe.permute_kernel(x, chosen, hist, None)
    total = int(offs[-1])
    h = torch._grouped_mm(rows, w13.transpose(1, 2), offs=offs)
    a = moe.swiglu_kernel(h, offs, INTER)[:total].float()
    a_p = moe.swiglu(h, INTER)[:total].float()
    # the plain version rounds silu to bf16 before the product: two
    # roundings against one, each within 2^-8 of the value
    assert ((a - a_p).abs() <= 2.0**-6 * a_p.abs() + 1e-30).all()
    y = torch._grouped_mm(moe.swiglu_kernel(h, offs, INTER), w2.transpose(1, 2), offs=offs)
    out = moe.combine_kernel(y, inverse, weights, valid).float()
    out_p = moe.combine(y, inverse.long(), weights, valid, torch.bfloat16).float()
    assert ((out - out_p).abs() <= 2.0**-7 * out_p.abs()).all()
    if valid is not None:
        assert bool((out[~valid] == 0).all())


@pytest.mark.parametrize("shape", SHAPES)
def test_the_layer_matches_the_plain_path_repeats_and_replays(dev, shape):
    """The kernel path against the plain path (use_kernels=False), with no
    host synchronisation, its launches counted; two runs give the same
    bits; each replay of a captured program gives the eager result's bits
    and is credited one launch of each kernel and one layer call."""
    x, gate, bias, w13, w2, valid = layer_inputs(dev, *SHAPES[shape])
    args = (x, gate, bias, w13, w2, K)
    counts, counts_p = (torch.zeros(3, dtype=torch.int64, device=dev) for _ in range(2))
    kernels = (moe.route_kernel, moe.permute_kernel, moe.swiglu_kernel, moe.combine_kernel)
    before = [f.launches for f in kernels]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.sparse_moe(*args, valid=valid, counts=counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [f.launches for f in kernels] == [n + 1 for n in before]
    out_p = moe.sparse_moe(*args, valid=valid, counts=counts_p, use_kernels=False)
    chosen, _, _ = moe.route_kernel(x, gate, bias, True, 1.0, valid)
    differ = flipped(x, gate, bias, chosen, moe.route(x, gate, bias, K, True, 1.0, valid)[0], valid)
    if not differ.any():
        assert torch.equal(counts, counts_p)
    keep = ~differ
    err = (out.float() - out_p.float())[keep].abs().max()
    assert err <= 0.01 * out_p.float()[keep].abs().max()
    if valid is not None:
        assert bool((out[~valid] == 0).all())
    assert torch.equal(moe.sparse_moe(*args, valid=valid), out)

    # replayed from a captured program: each replay credits one launch of
    # each kernel, as a decode chunk's or a prefill wave's graph does
    def program():
        inputs = graphs.static_inputs({"x": x}, dev)
        out = torch.empty_like(x)
        return graphs.Program(inputs, out, lambda: out.copy_(moe.sparse_moe(inputs["x"], *args[1:], valid=valid)))

    store = graphs.ProgramGraphs()
    store.run("moe", program, {"x": x})  # the capture, after an eager warm-up
    calls = moe.sparse_moe.launches
    for _ in range(3):
        before = [f.launches for f in kernels]
        replayed = store.run("moe", program, {"x": x})
        torch.cuda.synchronize()
        assert torch.equal(replayed, out)
        assert [f.launches for f in kernels] == [b + 1 for b in before]
    assert moe.sparse_moe.launches == calls + 3


def test_a_float32_input_raises_on_the_kernel_path(dev):
    """The kernels take bf16: a float32 layer call on the card with
    use_kernels raises rather than run the plain path."""
    x, gate, bias, w13, w2, _ = layer_inputs(dev, 129, None)
    with pytest.raises(TypeError, match="bf16 activations"):
        moe.sparse_moe(x.float(), gate, bias, w13, w2, K)
    out = moe.sparse_moe(x.float(), gate.float(), bias.float(), w13.float(), w2.float(), K, use_kernels=False)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
