"""The port's decoder against the JAX package's, on the CPU in float32, on
shared weights: prefill, merge_prefill, decode_step_chunked and commit_chunk
(max-abs 1e-4; cache contents compared on valid rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from surya_tpu_torch import nn as pnn
from surya_tpu.models import qwen_decoder as jax_decoder
from surya_tpu_torch.models import qwen_decoder
from surya_tpu_torch.recognition.loader import TINY_DECODER

torch.set_num_threads(1)
TOL = 1e-4


def _valid_rows_equal(ours, ref, lengths):
    """Cache [layers, slots, kvh, S, hd]: rows < lengths[slot] must agree."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    for s, n in enumerate(lengths):
        assert np.abs(ours[:, s, :, :n] - ref[:, s, :, :n]).max(initial=0) < TOL, s


def test_decoder_prefill_decode_commit():
    jcfg = jax_decoder.DecoderConfig(vocab_size=512, **TINY_DECODER)
    params = jax_decoder.init_params(jcfg, jax.random.PRNGKey(1))
    dec = qwen_decoder.Decoder(qwen_decoder.DecoderConfig(vocab_size=512, **TINY_DECODER))
    pnn.load_jax_params(dec, jax.tree.map(np.asarray, params))
    dec.requires_grad_(False)

    rng = np.random.default_rng(0)
    B, L, n_slots, S, K = 3, 16, 5, 64, 4
    embeds = rng.standard_normal((B, L, jcfg.hidden_size), dtype=np.float32)
    seq_lens = np.array([16, 9, 1], np.int32)
    slot_idx = np.array([2, 0, 4], np.int32)  # row 2 is padding: the trash slot

    # prefill
    jk, jv, jlast = jax.jit(jax_decoder.prefill, static_argnums=(1,), static_argnames="use_pallas")(
        params, jcfg, jnp.asarray(embeds), jnp.asarray(seq_lens), use_pallas=False
    )
    tk, tv, tlast = dec.prefill(torch.from_numpy(embeds), torch.from_numpy(seq_lens))
    assert np.abs(tlast.numpy() - np.asarray(jlast)).max() < TOL
    for b, n in enumerate(seq_lens):
        assert np.abs(tk[:, b, :n].numpy() - np.asarray(jk)[:, b, :n]).max() < TOL
        assert np.abs(tv[:, b, :n].numpy() - np.asarray(jv)[:, b, :n]).max() < TOL

    # merge into the slot cache
    jcache = jax_decoder.init_cache(jcfg, n_slots, S, jnp.float32)
    jcache = jax_decoder.merge_prefill(jcache, jk, jv, jnp.asarray(seq_lens), jnp.asarray(slot_idx))
    tcache = qwen_decoder.init_cache(dec.config, n_slots, S, torch.float32, "cpu")
    qwen_decoder.merge_prefill(tcache, tk, tv, torch.from_numpy(seq_lens), torch.from_numpy(slot_idx))
    lengths = np.asarray(jcache["len"])
    assert np.array_equal(tcache["len"].numpy(), lengths)
    _valid_rows_equal(tcache["k"], jcache["k"], lengths)
    _valid_rows_equal(tcache["v"], jcache["v"], lengths)

    # K decode steps over the frozen cache + the chunk buffer
    kv_shape = (jcfg.num_hidden_layers, n_slots, jcfg.num_key_value_heads, K, jcfg.head_dim)
    jck, jcv = jnp.zeros(kv_shape), jnp.zeros(kv_shape)
    tck, tcv = torch.zeros(kv_shape), torch.zeros(kv_shape)
    base = jcache["len"]
    jax_step = jax.jit(jax_decoder.decode_step_chunked, static_argnums=(1,), static_argnames="use_pallas")
    for step in range(K):
        emb = rng.standard_normal((n_slots, jcfg.hidden_size), dtype=np.float32)
        jck, jcv, jh = jax_step(
            params, jcfg, jcache, jck, jcv, jnp.asarray(emb), jnp.int32(step), base, use_pallas=False
        )
        th = dec.decode_step_chunked(tcache, tck, tcv, torch.from_numpy(emb), step, tcache["len"].clone())
        assert np.abs(th.numpy() - np.asarray(jh)).max() < TOL, step
    assert np.abs(tck.numpy() - np.asarray(jck)).max() < TOL
    assert np.abs(tcv.numpy() - np.asarray(jcv)).max() < TOL

    # commit: slot 3 was never filled, slot 1 stopped early
    advance = np.array([K, 2, K, 0, K], np.int32)
    jcache = jax_decoder.commit_chunk(jcache, jck, jcv, base, jnp.asarray(advance))
    qwen_decoder.commit_chunk(tcache, tck, tcv, tcache["len"].clone(), torch.from_numpy(advance))
    lengths = np.asarray(jcache["len"])
    assert np.array_equal(tcache["len"].numpy(), lengths)
    _valid_rows_equal(tcache["k"], jcache["k"], lengths)
    _valid_rows_equal(tcache["v"], jcache["v"], lengths)
