"""The port's vision encoder against the JAX package's, on the CPU in float32:
``plan_layout`` must give the same arrays, and ``VisionEncoder`` the same
image tokens as ``qwen_encoder.apply`` on shared weights (max-abs 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu_torch import nn as pnn
from surya_tpu.models import qwen_encoder as jax_encoder
from surya_tpu_torch.models import qwen_encoder
from surya_tpu_torch.recognition.loader import TINY_ENCODER

torch.set_num_threads(1)

GRID_SETS = [
    ([(2, 2)], 128),  # one minimal image
    ([(4, 40), (6, 24), (2, 30)], 512),  # edge windows, several images
    ([(8, 8), (8, 16), (16, 8)], 1024),  # exact window multiples
    ([(8, 60), (4, 40), (6, 30), (4, 64), (8, 40), (2, 30)], 2048),  # ranged windows
    ([], 256),  # empty wave
]


@pytest.mark.parametrize("grids,cap", GRID_SETS)
@pytest.mark.parametrize("config", ["default", "tiny"])
def test_plan_layout_matches_jax(grids, cap, config):
    kw = {} if config == "default" else TINY_ENCODER
    ours = qwen_encoder.plan_layout(grids, qwen_encoder.EncoderConfig(**kw), cap)
    ref = jax_encoder.plan_layout(grids, jax_encoder.EncoderConfig(**kw), cap)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_vision_encoder_matches_jax():
    cfg = jax_encoder.EncoderConfig(**TINY_ENCODER)
    params = jax_encoder.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    grids, cap = [(4, 40), (6, 24), (2, 30)], 512
    plan = jax_encoder.plan_layout(grids, cfg, cap)
    rng = np.random.default_rng(0)
    patches = np.zeros((cap, cfg.patch_dim), np.float32)
    patches[: plan.n_patches] = rng.standard_normal((plan.n_patches, cfg.patch_dim), dtype=np.float32)

    expected = np.asarray(
        jax_encoder.apply(
            params, cfg, jnp.asarray(patches), *map(jnp.asarray, plan.device_args),
            kv_range=plan.kv_range, win_range=plan.win_range,
        )
    )

    enc = qwen_encoder.VisionEncoder(qwen_encoder.EncoderConfig(**TINY_ENCODER))
    pnn.load_jax_params(enc, np_params)
    with torch.inference_mode():
        out = enc(
            torch.from_numpy(patches), *map(torch.from_numpy, plan.device_args),
            kv_range=plan.kv_range, win_range=plan.win_range,
        ).numpy()
    n = plan.n_llm_tokens
    assert out.shape == expected.shape
    assert np.abs(out[:n] - expected[:n]).max() < 1e-4


def test_load_jax_params_is_strict():
    """Weights carry over only when every JAX leaf meets a parameter of the
    same shape and every parameter gets a leaf."""
    cfg = jax_encoder.EncoderConfig(**TINY_ENCODER)
    params = jax.tree.map(np.asarray, jax_encoder.init_params(cfg, jax.random.PRNGKey(0)))
    enc = qwen_encoder.VisionEncoder(qwen_encoder.EncoderConfig(**TINY_ENCODER))
    bias = params["merger"]["mlp2"].pop("bias")
    with pytest.raises(KeyError, match="no JAX leaf"):
        pnn.load_jax_params(enc, params)
    params["merger"]["mlp2"]["bias"] = bias[:-1]
    with pytest.raises(ValueError, match="merger.mlp2.bias"):
        pnn.load_jax_params(enc, params)
    params["merger"]["mlp2"]["bias"] = bias
    params["merger"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="has no parameter"):
        pnn.load_jax_params(enc, params)
