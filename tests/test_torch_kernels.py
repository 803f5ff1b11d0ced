"""Plain versions of the port's three CUDA attention kernels against the JAX
package's Pallas kernels run in interpret mode, on the CPU, in float32.

Tolerance: 1e-5 max-abs (fp32; the two sides sum in different orders).
The CUDA kernels themselves run only on the card (chip_smoke.py compares
them with these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import qwen_encoder as jax_encoder
from surya_tpu.ops import decode_attn as jax_decode
from surya_tpu.ops import flash as jax_flash
from surya_tpu_torch.ops import decode_attn, flash

torch.set_num_threads(1)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _plan_case():
    """seg/window ids and ranges from a real layout plan (pads carry the
    per-chunk ids -2 - chunk)."""
    cfg = jax_encoder.EncoderConfig()
    plan = jax_encoder.plan_layout([(8, 60), (4, 40), (6, 30), (4, 64), (8, 40), (2, 30)], cfg, cap=2048)
    assert plan.seg_id[-1] == -2 - (2048 // 128 - 1)
    return plan


@pytest.mark.parametrize("case", ["unranged", "ranged_full", "ranged_window"])
def test_segmented_block_attention(case):
    rng = np.random.default_rng(0)
    S, H, D = 2048, 2, 80
    q, k, v = (rng.standard_normal((S, H, D), dtype=np.float32) * 0.3 for _ in range(3))
    plan = _plan_case()
    if case == "unranged":
        seg, starts, kv_range, block_k = plan.seg_id, np.zeros(S // 128, np.int32), S, 512
    elif case == "ranged_full":
        seg, starts, kv_range, block_k = plan.seg_id, plan.kv_starts, plan.kv_range, 512
        assert kv_range < S
    else:
        seg, starts, kv_range, block_k = plan.win_id, plan.win_starts, plan.win_range, 128
        assert kv_range < S and starts.max() > 0  # windows that are not the first one

    expected = np.asarray(
        jax_flash.segmented_block_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
            jnp.asarray(starts), kv_range, block_k=block_k, interpret=True,
        )
    )
    before = flash.segmented_block_attention.launches
    out = flash.segmented_block_attention(_t(q), _t(k), _t(v), _t(seg), _t(starts), kv_range)
    assert flash.segmented_block_attention.launches == before  # CPU tensors take the plain version
    assert np.abs(out.numpy() - expected).max() < TOL


def test_segmented_block_attention_strided_qkv():
    """The encoder hands q/k/v as strided views of one fused qkv output."""
    rng = np.random.default_rng(1)
    S, H, D = 256, 2, 80
    qkv = torch.from_numpy(rng.standard_normal((S, 3, H, D), dtype=np.float32) * 0.3)
    seg = torch.from_numpy(np.repeat(np.arange(4, dtype=np.int32), 64))
    starts = torch.zeros(2, dtype=torch.int32)
    out = flash.segmented_block_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], seg, starts, S)
    ref = flash.segmented_block_attention_reference(
        qkv[:, 0].contiguous(), qkv[:, 1].contiguous(), qkv[:, 2].contiguous(), seg, starts, S
    )
    assert torch.equal(out, ref)


@pytest.mark.parametrize("L,gqa", [(256, True), (256, False), (320, True)])
def test_causal_flash_attention(L, gqa):
    rng = np.random.default_rng(2)
    B, H, D = 2, 4, 64
    kvh = 2 if gqa else H
    q = rng.standard_normal((B, L, H, D), dtype=np.float32) * 0.3
    k = rng.standard_normal((B, L, kvh, D), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, L, kvh, D), dtype=np.float32) * 0.3
    expected = np.asarray(
        jax_flash.causal_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    )
    out = flash.causal_flash_attention(_t(q), _t(k), _t(v))
    assert np.abs(out.numpy() - expected).max() < TOL


@pytest.mark.parametrize(
    "lengths,step",
    [
        ([0, 17, 200, 256], 0),  # slot 0: the chunk's column 0 is its only key
        ([0, 17, 200, 256], 5),
        ([1, 255, 128, 3], 31),
        ([64, 64, 64, 64], 12),
    ],
)
def test_gqa_decode(lengths, step):
    rng = np.random.default_rng(3)
    B, H, kvh, D, S, K, layers = 4, 6, 2, 128, 256, 32, 2
    q = rng.standard_normal((B, H, D), dtype=np.float32) * 0.3
    kc, vc = (rng.standard_normal((layers, B, kvh, S, D), dtype=np.float32) * 0.3 for _ in range(2))
    ck, cv = (rng.standard_normal((layers, B, kvh, K, D), dtype=np.float32) * 0.3 for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    for layer in range(layers):
        expected = np.asarray(
            jax_decode.gqa_decode_pallas(
                jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                jnp.asarray(ck), jnp.asarray(cv), jnp.int32(step), layer, interpret=True,
            )
        )
        out = decode_attn.gqa_decode(_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, layer)
        assert np.abs(out.numpy() - expected).max() < TOL


def test_row_layout_check():
    """K1 takes the encoder's strided bf16 q/k/v views and refuses what its
    16-byte row loads cannot read."""
    qkv = torch.zeros((256, 3, 16, 80), dtype=torch.bfloat16)
    for i in range(3):
        flash._check_bf16_rows("k1", qkv[:, i])
    with pytest.raises(TypeError):
        flash._check_bf16_rows("k1", qkv[:, 0].float())
    with pytest.raises(ValueError, match="unit dim stride"):
        flash._check_bf16_rows("k1", qkv[:, 0].transpose(1, 2))
    with pytest.raises(ValueError, match="aligned"):
        flash._check_bf16_rows("k1", torch.zeros((256, 3 * 16 * 80 + 4), dtype=torch.bfloat16)[:, 4:].view(256, 3, 16, 80)[:, 0])


def test_kernel_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else that is not a
    CUDA tensor the kernel takes raises instead of falling back."""
    q = torch.empty((128, 2, 80), device="meta")
    seg = torch.empty((128,), dtype=torch.int32, device="meta")
    starts = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash.segmented_block_attention(q, q, q, seg, starts, 128)
    qc = torch.empty((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash.causal_flash_attention(qc, qc, qc)
    qd = torch.empty((2, 6, 128), device="meta")
    cache = torch.empty((1, 2, 2, 16, 128), device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.gqa_decode(qd, cache, cache, lens, cache, cache, 0, 0)
