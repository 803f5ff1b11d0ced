"""The port's multi-device mesh against the JAX package's, on the CPU, case by
case as tests/test_parallel.py: the JAX package on its 8 virtual CPU devices
(tests/conftest.py), its Pallas wrappers in interpret mode; the port on a
mesh of `cpu` devices (a device may repeat), where its kernel wrappers run
their plain versions once a shard. The same numpy inputs go to both.
Tolerances are stated per case."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu.common.predictor import BasePredictor as JaxBasePredictor
from surya_tpu.models import foundation as jax_foundation
from surya_tpu.models import qwen_decoder as jax_decoder
from surya_tpu.models import qwen_encoder as jax_encoder
from surya_tpu.ops import attention as jax_att
from surya_tpu.ops import decode_attn as jax_decode_attn
from surya_tpu.ops import flash as jax_flash
from surya_tpu.parallel import mesh as jax_mesh
from surya_tpu.recognition import util as jax_util
from surya_tpu.recognition.loader import load_recognition_model as jax_load_recognition
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.predictor import BasePredictor
from surya_tpu_torch.models import foundation, qwen_decoder, qwen_encoder
from surya_tpu_torch.ops import decode_attn, flash
from surya_tpu_torch.parallel import mesh as meshlib
from surya_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Sharded, make_mesh
from surya_tpu_torch.recognition import util
from surya_tpu_torch.recognition.loader import load_recognition_model
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(settings, name, os.devnull)
        yield


def cpu_mesh(n_data, n_model):
    return make_mesh(n_data, n_model, [CPU] * (n_data * n_model))


def jax_grid(n_data, n_model):
    return jax_mesh.make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[: n_data * n_model])


def rnd(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


# -- the mesh --------------------------------------------------------------------


def test_make_mesh_shapes():
    """make_mesh's shape and grid as the JAX package's, on explicit devices;
    a device may repeat; the model axis defaults to MESH_NUM_MODEL_SHARDS."""
    mesh = cpu_mesh(4, 2)
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 2} == dict(jax_grid(4, 2).shape)
    assert mesh.coords() == [(d, m) for d in range(4) for m in range(2)] and mesh.distinct() == [CPU]
    cards = [torch.device("cuda", i) for i in range(4)]
    logical = make_mesh(2, 2, [cards[0]] * 4)
    assert logical.shape == {DATA_AXIS: 2, MODEL_AXIS: 2} and logical.distinct() == [cards[0]]
    assert logical.first == cards[0] and logical.device(1, 1) == cards[0]
    spread = make_mesh(devices=cards, n_model=2)  # n_data from the devices, as JAX
    assert spread.shape == {DATA_AXIS: 2, MODEL_AXIS: 2} and spread.device(1, 0) == cards[2]
    assert spread.distinct() == cards
    old = settings.MESH_NUM_MODEL_SHARDS
    settings.MESH_NUM_MODEL_SHARDS = 4
    try:
        assert make_mesh(devices=cards).shape == {DATA_AXIS: 1, MODEL_AXIS: 4}
    finally:
        settings.MESH_NUM_MODEL_SHARDS = old
    with pytest.raises(ValueError):
        make_mesh(4, 2, cards)


@pytest.mark.parametrize("shape,batch,heads", [
    ((2, 4), 8, (4, 2)), ((2, 4), 8, (8, 4)), ((2, 4), 7, (8, 4)), ((4, 2), 8, (12, 4)),
    ((8, 1), 16, (3, 1)), ((1, 8), 5, (8, 8)), ((4, 2), 6, (4, 2)),
])
def test_kernel_shardable_as_jax(shape, batch, heads):
    """The dispatch rule on the odd meshes of test_parallel.py and others:
    the same answer as the JAX package's."""
    assert meshlib.kernel_shardable(cpu_mesh(*shape), batch, *heads) == \
        jax_mesh.kernel_shardable(jax_grid(*shape), batch, *heads)


@pytest.mark.parametrize("spec,shape", [
    ((None, DATA_AXIS, MODEL_AXIS, None), (3, 8, 4, 5)),
    ((DATA_AXIS, None, MODEL_AXIS, None), (7, 2, 3, 4)),  # uneven on both axes
    ((None,), (6,)),
])
def test_sharded_split_and_gather(spec, shape):
    """Sharded.split gives each shard its block as a tensor of its own;
    gather joins them back to the global array, uneven splits included."""
    mesh = cpu_mesh(4, 2)
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    s = Sharded.split(x, mesh, spec)
    assert torch.equal(s.gather(), x)
    assert all(t.data_ptr() != x.data_ptr() and t.is_contiguous() for t in s.shards.values())
    assert [s.global_size(i) for i in range(len(shape))] == list(shape)


def test_all_reduce_sum_in_model_order():
    parts = [torch.full((2,), float(m + 1)) for m in range(3)]
    out = meshlib.all_reduce_sum(parts, [CPU] * 3)
    assert all(torch.equal(o, torch.full((2,), 6.0)) for o in out) and len({id(o) for o in out}) == 3


# -- placement --------------------------------------------------------------------


def _tiny_port_foundation(quantize: bool):
    """The tiny foundation of test_parallel.py, in the port, random weights."""
    enc = qwen_encoder.EncoderConfig(depth=1, hidden_size=64, intermediate_size=128, num_heads=4, window_size=56,
                                     out_hidden_size=64, fullatt_block_indexes=())
    dec = qwen_decoder.DecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                     num_attention_heads=4, num_key_value_heads=2)
    model = foundation.FoundationModel(foundation.FoundationConfig(vocab_size=128, encoder=enc, decoder=dec))
    pnn.init_normal_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.normal_(0.0, 0.1)  # biases not zero, so that their slices are checked
    if quantize:
        qwen_decoder.quantize_weights(model.decoder)
    return model.eval().requires_grad_(False)


@pytest.mark.parametrize("quantize", [False, True])
def test_tp_placement(quantize):
    """The TP plan of _decoder_tp_spec: q/k/v/gate/up column slices and o/down
    row slices that, joined over the model axis, give the full weights (int8
    weight_q like the weight; scales and biases like a bias: sliced on column
    layers, whole on row layers); the replicated parameters are the model's
    own on its device."""
    model = _tiny_port_foundation(quantize)
    mesh = cpu_mesh(4, 2)
    placement = meshlib.Placement(model, mesh)
    assert placement.replicas == {CPU: model}
    for li, layer in enumerate(model.decoder.layers):
        for block, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                full = getattr(getattr(layer, block), name)
                parts = [getattr(getattr(placement.decoder_shard(1, m).layers[li], block), name) for m in range(2)]
                dim = 0 if name in meshlib.COLUMN else 1
                key = "weight_q" if quantize else "weight"
                assert torch.equal(torch.cat([getattr(p, key) for p in parts], dim), getattr(full, key)), name
                for attr in ("scale", "bias") if quantize else ("bias",):
                    if getattr(full, attr, None) is None:
                        assert all(getattr(p, attr, None) is None for p in parts)
                        continue
                    got = [getattr(p, attr) for p in parts]
                    joined = torch.cat(got) if dim == 0 else got[0]
                    assert torch.equal(joined, getattr(full, attr)), (name, attr)
                    assert dim == 0 or all(torch.equal(g, getattr(full, attr)) for g in got)
    shard = placement.decoder_shard(0, 1)
    assert (shard.n_heads, shard.n_kv_heads) == (2, 1)
    assert shard.layers[0].input_layernorm is model.decoder.layers[0].input_layernorm  # replicated: shared
    assert placement.decoder_shard(3, 1) is shard  # once a (device, model index)


def test_tp_placement_matches_jax_shards():
    """Shard (d, m)'s slice of each kernel is the block that the JAX
    package's shard_foundation_params puts on device (d, m) of its mesh."""
    jenc = jax_encoder.EncoderConfig(depth=1, hidden_size=64, intermediate_size=128, num_heads=4, window_size=56,
                                     out_hidden_size=64, fullatt_block_indexes=())
    jdec = jax_decoder.DecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                                     num_attention_heads=4, num_key_value_heads=2)
    jcfg = jax_foundation.FoundationConfig(vocab_size=128, encoder=jenc, decoder=jdec)
    params = jax_foundation.init_params(jcfg, jax.random.PRNGKey(0))
    grid = jax_grid(4, 2)
    sharded = jax_mesh.shard_foundation_params(params, grid)
    enc = qwen_encoder.EncoderConfig(**{k: getattr(jenc, k) for k in ("depth", "hidden_size", "intermediate_size",
                                                                     "num_heads", "window_size", "out_hidden_size",
                                                                     "fullatt_block_indexes")})
    dec = qwen_decoder.DecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                                     num_attention_heads=4, num_key_value_heads=2)
    model = foundation.FoundationModel(foundation.FoundationConfig(vocab_size=128, encoder=enc, decoder=dec))
    pnn.load_jax_params(model, jax.tree.map(np.asarray, params))
    placement = meshlib.Placement(model.eval(), cpu_mesh(4, 2))
    where = {dev: (d, m) for d, row in enumerate(grid.devices) for m, dev in enumerate(row)}
    for block, name in (("self_attn", "q_proj"), ("self_attn", "v_proj"), ("self_attn", "o_proj"),
                        ("mlp", "up_proj"), ("mlp", "down_proj")):
        kernel = sharded["decoder"]["layers"][0][block][name]["kernel"]
        for shard in kernel.addressable_shards:
            d, m = where[shard.device]
            ours = getattr(getattr(placement.decoder_shard(d, m).layers[0], block), name).weight
            assert np.array_equal(ours.numpy(), np.asarray(shard.data).T), (name, d, m)


def test_replicas_once_per_distinct_device():
    """On a mesh of two distinct devices (the CPU and the meta device) the
    replicated parameters exist once a device and the TP slices once a
    (device, model index); the other device's replica has no decoder
    projections (its shards hold the slices)."""
    model = _tiny_port_foundation(False)
    meta = torch.device("meta")
    mesh = meshlib.Mesh([[CPU, meta], [CPU, meta]])
    placement = meshlib.Placement(model, mesh)
    assert set(placement.replicas) == {CPU, meta} and placement.replicas[CPU] is model
    rep = placement.replicas[meta]
    assert rep.token_embed.weight.device == meta and rep.decoder.layers[0].self_attn is None
    assert placement.decoder_shard(0, 1) is placement.decoder_shard(1, 1)
    assert placement.decoder_shard(0, 1).layers[0].self_attn.q_proj.weight.device == meta
    assert placement.decoder_shard(0, 0).layers[0].self_attn.q_proj.weight.device == CPU


# -- the three kernel wrappers -------------------------------------------------------


def _decode_inputs(quantized, rng, layers=2, B=8, H=8, kvh=4, S=256, K=8, D=64):
    """test_parallel.py's inputs, as numpy (float32; int8 and bf16 scales)."""
    q, ck, cv = rnd(rng, B, H, D), rnd(rng, layers, B, kvh, K, D), rnd(rng, layers, B, kvh, K, D)
    lengths = rng.integers(1, S, B).astype(np.int32)
    if quantized:
        kc = rng.integers(-127, 127, (layers, B, kvh, S, D)).astype(np.int8)
        vc = rng.integers(-127, 127, (layers, B, kvh, S, D)).astype(np.int8)
        # bf16 scales, held as the float32 values bf16 rounds them to
        ks, vs = (np.asarray(jnp.asarray(rng.random((layers, B, kvh, S), dtype=np.float32) * 0.01 + 1e-3,
                                         jnp.bfloat16).astype(jnp.float32)) for _ in range(2))
    else:
        kc, vc = rnd(rng, layers, B, kvh, S, D), rnd(rng, layers, B, kvh, S, D)
        ks = vs = None
    return q, kc, vc, lengths, ck, cv, ks, vs


def _port_decode_args(mesh, q, kc, vc, lengths, ck, cv, ks, vs):
    spec = qwen_decoder.CACHE_SPECS

    def t(a, dtype=None):
        x = torch.from_numpy(np.array(a))
        return x if dtype is None else x.to(dtype)

    args = [Sharded.split(t(q), mesh, qwen_decoder.DECODE_Q_SPEC), Sharded.split(t(kc), mesh, spec["k"]),
            Sharded.split(t(vc), mesh, spec["v"]), Sharded.split(t(lengths), mesh, spec["len"]),
            Sharded.split(t(ck), mesh, qwen_decoder.CHUNK_SPEC), Sharded.split(t(cv), mesh, qwen_decoder.CHUNK_SPEC)]
    scales = [None, None] if ks is None else [Sharded.split(t(s, torch.bfloat16), mesh, spec["k_scale"])
                                              for s in (ks, vs)]
    return args, scales


@pytest.mark.parametrize("quantized", [False, True])
def test_gqa_decode_shard_map_matches_jax(quantized, monkeypatch):
    """K3-mesh on a 4x2 mesh (slots over data, kv heads over model) against
    the JAX package's gqa_decode_shard_map (interpret) and its reference:
    max|diff| < 1e-4 in float32, < 2e-2 with the int8 cache (the JAX test's
    bounds). Each of the 8 shards runs the plain version once, at its shapes."""
    rng = np.random.default_rng(0)
    q, kc, vc, lengths, ck, cv, ks, vs = _decode_inputs(quantized, rng)
    step, layer = 3, 1
    jargs = [jnp.asarray(a) for a in (q, kc, vc, lengths, ck, cv)]
    jscales = [None, None] if ks is None else [jnp.asarray(s, jnp.bfloat16) for s in (ks, vs)]
    fn = lambda *a: jax_decode_attn.gqa_decode_shard_map(*a, mesh=jax_grid(4, 2), interpret=True)  # noqa: E731
    expected = np.asarray(jax.jit(fn)(*jargs, jnp.int32(step), jnp.int32(layer), *jscales))
    reference = np.asarray(jax_decode_attn.gqa_decode_reference(*jargs, step, layer, *jscales))

    mesh = cpu_mesh(4, 2)
    args, scales = _port_decode_args(mesh, q, kc, vc, lengths, ck, cv, ks, vs)
    shapes = []
    plain = decode_attn.gqa_decode_reference
    monkeypatch.setattr(decode_attn, "gqa_decode_reference",
                        lambda *a: shapes.append((tuple(a[0].shape), tuple(a[1].shape))) or plain(*a))
    out = decode_attn.gqa_decode(*args, step, layer, *scales, mesh=mesh).gather().numpy()
    assert shapes == [((2, 4, 64), (2, 2, 2, 256, 64))] * 8
    tol = 2e-2 if quantized else 1e-4
    assert np.abs(out - expected).max() < tol and np.abs(out - reference).max() < tol


def test_prefill_kernels_shard_map_match_jax(monkeypatch):
    """K2-mesh (rows over data, heads over model) and K1-mesh (replicated)
    on a 4x2 mesh against the JAX package's wrappers in interpret mode:
    max|diff| < 1e-4."""
    rng = np.random.default_rng(1)
    B, L, H, kvh, D = 4, 128, 4, 2, 64
    q, k, v = rnd(rng, B, L, H, D), rnd(rng, B, L, kvh, D), rnd(rng, B, L, kvh, D)
    grid = jax_grid(4, 2)
    expected = np.asarray(jax.jit(lambda a, b, c: jax_flash.causal_flash_attention_shard_map(
        a, b, c, grid, interpret=True))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    mesh = cpu_mesh(4, 2)
    spec = qwen_decoder.PREFILL_SPEC
    calls = []
    plain = flash.causal_flash_attention_reference
    monkeypatch.setattr(flash, "causal_flash_attention_reference", lambda *a: calls.append(a[0].shape) or plain(*a))
    out = flash.causal_flash_attention(*(Sharded.split(torch.from_numpy(x), mesh, spec) for x in (q, k, v)),
                                       mesh=mesh)
    assert calls == [(1, L, 2, D)] * 8
    assert np.abs(out.gather().numpy() - expected).max() < 1e-4

    S, He, De = 512, 4, 64
    seg = np.full(S, -1, np.int32)
    seg[:200], seg[200:448] = 0, 1
    qs, ks2, vs2 = rnd(rng, S, He, De), rnd(rng, S, He, De), rnd(rng, S, He, De)
    starts = np.zeros(S // 128, np.int32)
    expected2 = np.asarray(jax.jit(lambda a, b, c, sg, st: jax_flash.segmented_block_attention_shard_map(
        a, b, c, sg, st, S, grid, interpret=True))(*(jnp.asarray(x) for x in (qs, ks2, vs2, seg, starts))))
    rep = [Sharded.split(torch.from_numpy(x), mesh, (None,) * x.ndim) for x in (qs, ks2, vs2, seg, starts)]
    out2 = flash.segmented_block_attention_shard_map(*rep, S, mesh)
    assert len(out2.shards) == 8
    for t in out2.shards.values():  # every shard holds the whole result
        assert np.abs(t.numpy() - expected2).max() < 1e-4


@pytest.mark.parametrize("shape,B,H,kvh", [((2, 4), 8, 4, 2), ((2, 1), 7, 8, 4), ((2, 4), 7, 4, 2)])
def test_unshardable_mesh_takes_the_gathered_kernel(shape, B, H, kvh, monkeypatch):
    """A mesh that does not divide the kv heads or the slots (test_parallel.py's
    odd mesh, and an odd slot count): the dispatcher gives the reference's
    numbers, as the JAX package's does (max|diff| < 1e-5), through the
    gathered single-device branch: the per-shard wrapper is never called and
    the plain version runs once, on the whole batch and the layer's slice."""
    layers, S, K, D = 2, 16, 4, 8
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((layers, B, kvh, S, D)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.standard_normal((layers, B, kvh, K, D)).astype(np.float32) for _ in range(2))
    lens = np.full((B,), 8, np.int32)
    grid = jax_grid(*shape)
    with grid:
        expected = np.asarray(jax.jit(lambda *a: jax_decode_attn.gqa_decode(*a, use_pallas=True, mesh=grid))(
            *(jnp.asarray(x) for x in (q, kc, vc, lens, ck, cv)), jnp.int32(2), jnp.int32(1)))
    reference = np.asarray(jax_decode_attn.gqa_decode_reference(
        *(jnp.asarray(x) for x in (q, kc, vc, lens, ck, cv)), jnp.int32(2), jnp.int32(1)))
    assert np.abs(expected - reference).max() < 1e-5

    mesh = cpu_mesh(*shape)
    args, scales = _port_decode_args(mesh, q, kc, vc, lens, ck, cv, None, None)
    monkeypatch.setattr(decode_attn, "gqa_decode_shard_map", lambda *a, **k: pytest.fail("per-shard path taken"))
    calls = []
    plain = decode_attn.gqa_decode_reference
    monkeypatch.setattr(decode_attn, "gqa_decode_reference",
                        lambda *a: calls.append((tuple(a[0].shape), tuple(a[1].shape), a[7])) or plain(*a))
    out = decode_attn.gqa_decode(*args, 2, 1, *scales, mesh=mesh)
    assert calls == [((B, H, D), (1, B, kvh, S, D), 0)]
    assert set(out.shards) == set(mesh.coords()) and np.abs(out.gather().numpy() - reference).max() < 1e-5

    # K2 on the same mesh: the gathered branch, the dense causal reference's numbers
    L = 16
    qp, kp, vp = rnd(rng, B, L, H, D), rnd(rng, B, L, kvh, D), rnd(rng, B, L, kvh, D)
    causal = jax_att.mask_to_bias(jnp.tril(jnp.ones((L, L), bool)))[None, None]
    dense = np.asarray(jax_att.sdpa(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp), bias=causal))
    monkeypatch.setattr(flash, "causal_flash_attention_shard_map", lambda *a, **k: pytest.fail("per-shard path"))
    spec = qwen_decoder.PREFILL_SPEC
    outp = flash.causal_flash_attention(*(Sharded.split(torch.from_numpy(x), mesh, spec) for x in (qp, kp, vp)),
                                        mesh=mesh)
    assert np.abs(outp.gather().numpy() - dense).max() < 1e-5


# -- host planning -------------------------------------------------------------------


def _recognition_models():
    params, jcfg, jproc = jax_load_recognition(checkpoint=os.devnull, tiny=True)
    np_params = jax.tree.map(np.asarray, params)
    model, cfg, proc = load_recognition_model(tiny=True, device="cpu", jax_params=np_params)
    return params, jcfg, jproc, np_params, model, cfg, proc


@pytest.fixture(scope="module")
def recognition_models():
    return _recognition_models()


def test_plan_layout_sharded_matches_jax(recognition_models):
    """Stacked per-shard plans: every array, both window lengths and the
    per-input tokens_per_image as the JAX package's."""
    _, jcfg, _, _, _, cfg, _ = recognition_models
    shard_grids = [[(4, 6), (6, 8)], [(4, 4)], [(8, 6), (4, 8), (2, 2)]]
    groups = [[2, 0], [4], [1, 3, 5]]
    ours = qwen_encoder.plan_layout_sharded(shard_grids, cfg.encoder, 1024, orig_index=groups)
    ref = jax_encoder.plan_layout_sharded(shard_grids, jcfg.encoder, 1024, orig_index=groups)
    for a, b in zip(ours.device_args + (ours.llm_h_idx, ours.llm_w_idx),
                    ref.device_args + (ref.llm_h_idx, ref.llm_w_idx)):
        assert a.shape[0] == 3 and np.array_equal(a, b)
    assert (ours.kv_range, ours.win_range, ours.tokens_per_image) == (ref.kv_range, ref.win_range,
                                                                     ref.tokens_per_image)


def test_build_prefill_batch_sharded_matches_jax(recognition_models):
    """n_shards=2: the JAX package's bundle (patches, rows, gathers, lengths,
    valid_rows, plan); group-contiguous rows holding the flat build's
    content; shard-local gathers; padding rows stay padding."""
    _, jcfg, jproc, _, _, cfg, proc = recognition_models
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in [(56, 224), (56, 112), (28, 112), (56, 168)]]

    def build(p, c, n_shards):
        return p.build_prefill_batch(imgs, ["ocr_with_boxes"] * 4, [None] * 4, [True] * 4, c.encoder, batch_rows=8,
                                     seq_buckets=(128,), patch_caps=(1024, 4096), n_shards=n_shards)

    sh, ref, flat = build(proc, cfg, 2), build(jproc, jcfg, 2), build(proc, cfg, 1)
    for name in ("patches", "input_ids", "img_gather", "seq_lens", "valid_rows"):
        assert np.array_equal(getattr(sh, name), getattr(ref, name)), name
    for a, b in zip(sh.layout.device_args, ref.layout.device_args):
        assert np.array_equal(a, b)
    assert sh.patches.shape[0] == 2 and sorted(sh.valid_rows.tolist()) == sorted(set(sh.valid_rows.tolist()))
    for i, r in enumerate(sh.valid_rows):
        assert np.array_equal(sh.input_ids[r], flat.input_ids[i]) and sh.seq_lens[r] == flat.seq_lens[i]
        assert sh.img_gather[r].max() < sh.layout.unscatter.shape[1]
    for r in sorted(set(range(8)) - set(sh.valid_rows.tolist())):
        assert (sh.input_ids[r] == proc.pad_token_id).all()
    assert sh.layout.tokens_per_image == flat.layout.tokens_per_image
    assert np.array_equal(flat.valid_rows, np.arange(4))


@pytest.mark.parametrize("frees,block", [([0, 1, 2, 5, 6, 9, 10, 11], 4), (list(range(16)), 8), ([3, 4], 0),
                                         ([7, 1, 4], 2)])
def test_interleave_shard_slots_matches_jax(frees, block):
    assert util.interleave_shard_slots(list(frees), block) == jax_util.interleave_shard_slots(list(frees), block)


def test_bucket_rows_rounds_after_the_max():
    """bucket_rows on a data axis of 4 with current > batch_size: the port's
    count is aligned (rounded after the max); the JAX package's is not (it
    rounds before: the reference fault of ROADMAP.md)."""
    ours = BasePredictor.__new__(BasePredictor)
    ours.mesh = cpu_mesh(4, 1)
    ref = JaxBasePredictor.__new__(JaxBasePredictor)

    class FakeMesh:
        shape = {"data": 4}

    ref.mesh = FakeMesh()
    old = jax_settings.MESH_DATA_AXIS
    jax_settings.MESH_DATA_AXIS = "data"
    try:
        assert ref.bucket_rows(18, 16) == 18  # unaligned
        assert ours.bucket_rows(18, 16) == 20
        for current in (1, 3, 8, 9, 16):
            assert ours.bucket_rows(current, 16) == ref.bucket_rows(current, 16)
            assert ours.bucket_rows(current, 16) % 4 == 0
    finally:
        jax_settings.MESH_DATA_AXIS = old
    ours.mesh = None
    assert [ours.bucket_rows(n, 8) for n in (1, 2, 3, 5, 8, 11)] == [1, 2, 4, 8, 8, 11]


# -- the sharded prefill ---------------------------------------------------------------


def test_sharded_encoder_prefill_matches_flat_and_jax(recognition_models):
    """The data-sharded prefill on a 4x2 mesh (a packed plan a data shard,
    group-contiguous rows, shard-local gathers, the decoder over the model
    axis) gives the flat path's token 0 (equal), scores (< 1e-4) and
    int bboxes (within 1), and the JAX package's sharded prefill's
    (test_parallel.py's case, on the recognition tiny model); its KV rows
    land in the slots the flat path puts them, slots permuted across the
    data shards."""
    params, jcfg, _, _, model, cfg, _ = recognition_models
    enc = cfg.encoder
    mesh, grid, n_data = cpu_mesh(4, 2), jax_grid(4, 2), 4
    rng = np.random.default_rng(0)
    B, L = 8, 64
    grids = [(4, 6), (6, 8), (4, 4), (4, 6), (8, 6), (4, 4), (6, 6), (4, 8)]
    raw = [rnd(rng, h * w, enc.patch_dim) for h, w in grids]
    n_tok = [h * w // 4 for h, w in grids]
    IMG, BOS, EOI, PAD = cfg.image_token_id, cfg.bos_token_id, 10, cfg.pad_token_id

    def rows(order, local):
        ids, gather, lens = np.full((B, L), PAD, np.int32), np.full((B, L), -1, np.int32), np.zeros(B, np.int32)
        base = 0
        for pos, i in enumerate(order):
            if local and pos % (B // n_data) == 0:
                base = 0
            row = [IMG] * n_tok[i] + [4, 5, 6, 7] + [BOS, 20 + i, EOI]
            ids[pos, : len(row)] = row
            gather[pos, : n_tok[i]] = np.arange(base, base + n_tok[i])
            base += n_tok[i]
            lens[pos] = len(row)
        return ids, gather, lens

    slot_idx = np.array([5, 0, 7, 2, 1, 6, 3, 4], np.int32)  # rows to slots of other data shards
    layout = qwen_encoder.plan_layout(grids, enc, 512)
    flat_patches = np.zeros((512, enc.patch_dim), np.float32)
    flat_patches[: sum(x.shape[0] for x in raw)] = np.concatenate(raw)
    ids, gather, lens = rows(range(B), False)
    t = torch.from_numpy
    cache = qwen_decoder.init_cache(cfg.decoder, B, 128, torch.float32, CPU)
    tok_f, score_f, bbox_f = model.prefill(cache, t(flat_patches), tuple(t(a) for a in layout.device_args),
                                           t(layout.llm_h_idx), t(layout.llm_w_idx), t(ids), t(gather), t(lens),
                                           t(slot_idx), layout.kv_range, layout.win_range)

    groups = [[2 * g, 2 * g + 1] for g in range(n_data)]
    slay = qwen_encoder.plan_layout_sharded([[grids[i] for i in g] for g in groups], enc, 256)
    spatches = np.zeros((n_data, 256, enc.patch_dim), np.float32)
    for g, idxs in enumerate(groups):
        cat = np.concatenate([raw[i] for i in idxs])
        spatches[g, : cat.shape[0]] = cat
    ids_s, gather_s, lens_s = rows([i for g in groups for i in g], True)
    meshed = foundation.MeshedFoundation(model, mesh)
    scache = qwen_decoder.init_cache(cfg.decoder, B, 128, torch.float32, CPU, mesh=mesh)
    inputs, seq_lens = {}, {}
    for d, m in mesh.coords():
        lo, hi = 2 * d, 2 * d + 2
        inputs[d, m] = (t(spatches[d]), tuple(t(a[d]) for a in slay.device_args), t(slay.llm_h_idx[d]),
                        t(slay.llm_w_idx[d]), t(ids_s[lo:hi]), t(gather_s[lo:hi]))
        seq_lens[d, m] = t(lens_s[lo:hi])
    src = foundation.slot_sources(slot_idx, np.ones(B, bool), B)
    sources = {(d, m): t(src[2 * d:2 * d + 2]) for d, m in mesh.coords()}
    assert any((src[2 * d:2 * d + 2] // 2 != d).any() for d in range(n_data))  # rows to other data shards' slots
    out = meshed.prefill(scache, inputs, seq_lens, sources, slay.kv_range, slay.win_range, sharded=True)
    tok_s = torch.cat([out[d, 0][0] for d in range(n_data)])
    score_s = torch.cat([out[d, 0][1] for d in range(n_data)])
    bbox_s = torch.cat([out[d, 0][2] for d in range(n_data)])
    for m in range(2):  # every model shard sampled the same token 0
        assert torch.equal(torch.cat([out[d, m][0] for d in range(n_data)]), tok_s)
    assert torch.equal(tok_s, tok_f) and (score_s - score_f).abs().max() < 1e-4
    assert (bbox_s - bbox_f).abs().max() <= 1
    assert torch.equal(scache["len"].gather(), cache["len"])
    assert (scache["k"].gather() - cache["k"]).abs().max() < 1e-4

    with grid:
        _, tok_j, score_j, bbox_j = jax.jit(lambda c, p, ea, h, w, i2, g2, l2, s2: jax_foundation.prefill(
            params, jcfg, c, p, ea, h, w, i2, g2, l2, s2, kv_range=slay.kv_range, win_range=slay.win_range,
            use_pallas=False, mesh=grid,
        ))(jax_decoder.init_cache(jcfg.decoder, B, 128, jnp.float32), jnp.asarray(spatches),
           tuple(jnp.asarray(a) for a in slay.device_args), jnp.asarray(slay.llm_h_idx), jnp.asarray(slay.llm_w_idx),
           jnp.asarray(ids_s), jnp.asarray(gather_s), jnp.asarray(lens_s), jnp.arange(B, dtype=jnp.int32))
    assert np.array_equal(tok_s.numpy(), np.asarray(tok_j))
    assert np.abs(score_s.numpy() - np.asarray(score_j)).max() < 1e-4
    assert np.abs(bbox_s.numpy() - np.asarray(bbox_j)).max() <= 1


# -- the predictors on a mesh ------------------------------------------------------------


def _line_page():
    img = Image.new("RGB", (512, 256), "white")
    ImageDraw.Draw(img).text((10, 10), "tp mesh test line", fill="black", font_size=24)
    return img


def _record_tokens(pred):
    """Keep prediction_loop's token ids on pred.tokens."""
    loop = pred.prediction_loop

    def recording(*args, **kwargs):
        out = loop(*args, **kwargs)
        pred.tokens = [list(t) for t in out[0]]
        return out

    pred.prediction_loop = recording


@pytest.fixture(scope="module")
def unsharded_recognition():
    """The JAX package's and the port's unsharded predictors on one tiny
    model (a local path that does not exist: random init, no download)."""
    from surya_tpu.recognition import RecognitionPredictor as JaxPredictor
    from surya_tpu_torch.recognition import RecognitionPredictor

    ref = JaxPredictor(checkpoint=os.devnull, tiny=True)
    params = jax.tree.map(np.asarray, ref.params)
    ours = RecognitionPredictor(tiny=True, device="cpu", jax_params=params)
    for p in (ref, ours):
        _record_tokens(p)
    return ref, ours, params


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (1, 2)])
def test_meshed_recognition_predictor_matches_jax(shape, unsharded_recognition, monkeypatch):
    """RecognitionPredictor on an 8x1, 4x2 and 1x2 mesh of the CPU (the 1x2
    mesh's encoder runs K1-mesh), built from the JAX tiny model, against the
    JAX predictor on the same mesh (USE_MESH, its 8 virtual devices): the
    same text and token ids, confidences within 1e-3; and the port's
    unsharded predictor's."""
    from surya_tpu.recognition import RecognitionPredictor as JaxPredictor
    from surya_tpu_torch.recognition import RecognitionPredictor

    _, single, params = unsharded_recognition
    n_data, n_model = shape
    monkeypatch.setattr(jax_settings, "USE_MESH", True)
    monkeypatch.setattr(jax_settings, "MESH_NUM_MODEL_SHARDS", n_model)
    grid = jax_grid(n_data, n_model)
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda *a, **k: grid)
    ref = JaxPredictor(checkpoint=os.devnull, tiny=True)
    assert dict(ref.mesh.shape) == {"data": n_data, "model": n_model}
    ours = RecognitionPredictor(tiny=True, jax_params=params, mesh=cpu_mesh(n_data, n_model))
    assert (ours.n_slots, ours.prefill_rows, ours.prefill_row_buckets) == (ref.n_slots, ref.prefill_rows,
                                                                         ref.prefill_row_buckets)
    for p in (ref, ours):
        p.patch_caps, p.patch_cap = (1024, 4096), 4096
        _record_tokens(p)
    page, bboxes = _line_page(), [[[5, 5, 200, 40], [5, 60, 300, 100], [5, 120, 400, 160]]]
    expected = ref([page], bboxes=bboxes)
    got = ours([page], bboxes=bboxes)
    base = single([page], bboxes=bboxes)
    assert ours.tokens == ref.tokens == single.tokens
    for line, ref_line, base_line in zip(got[0].text_lines, expected[0].text_lines, base[0].text_lines):
        assert line.text == ref_line.text == base_line.text
        assert abs(line.confidence - ref_line.confidence) < 1e-3
        assert abs(line.confidence - base_line.confidence) < 1e-3
    assert len(got[0].text_lines) == 3


def test_meshed_recognition_unaligned_batch(unsharded_recognition):
    """A caller's batch whose slots plus the trash slot the data axis does
    not divide (test_parallel.py's regression): the slot count is realigned
    and the run gives the unsharded tokens."""
    from surya_tpu_torch.recognition import RecognitionPredictor

    _, single, params = unsharded_recognition
    ours = RecognitionPredictor(tiny=True, jax_params=params, mesh=cpu_mesh(8, 1))
    _record_tokens(ours)
    page, bboxes = _line_page(), [[[5, 5, 200, 40]]]
    [got] = ours([page], bboxes=bboxes, recognition_batch_size=8)
    [base] = single([page], bboxes=bboxes, recognition_batch_size=8)
    assert ours.tokens == single.tokens and got.text_lines[0].text == base.text_lines[0].text


def test_meshed_batch_predictors():
    """Detection, layout, table recognition and OCR error on an 8x1 mesh of
    the CPU: the port's unsharded results (boxes, labels, table rows, columns
    and cells) and the JAX package's unsharded and meshed ones
    (test_parallel.py's case: labels equal, table row polygons within 1 px)."""
    from surya_tpu.detection import DetectionPredictor as JaxDetection
    from surya_tpu.layout import LayoutPredictor as JaxLayout
    from surya_tpu.ocr_error import OCRErrorPredictor as JaxOCRError
    from surya_tpu.table_rec import TableRecPredictor as JaxTableRec
    from surya_tpu.table_rec import install_synthetic_tables as jax_tables
    from surya_tpu_torch.detection import DetectionPredictor
    from surya_tpu_torch.layout import LayoutPredictor
    from surya_tpu_torch.ocr_error import OCRErrorPredictor
    from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables

    img = Image.new("RGB", (512, 512), "white")
    d = ImageDraw.Draw(img)
    d.text((20, 30), "mesh layout line", fill="black", font_size=24)
    d.rectangle((50, 200, 450, 400), outline="black", width=2)
    table_img = img.crop((40, 180, 470, 420))
    texts = ["This is a sensible sentence.", "a]]3 ;;garbled@@ t3xt//"]
    mesh = cpu_mesh(8, 1)

    def results(det, lay, tab, err):
        return ([b.bbox for b in det([img.copy()])[0].bboxes], [b.label for b in lay([img.copy()])[0].bboxes],
                tab([table_img.copy()])[0], err(texts).labels)

    old = jax_settings.TABLE_REC_MAX_BOXES, settings.TABLE_REC_MAX_BOXES
    jax_settings.TABLE_REC_MAX_BOXES = settings.TABLE_REC_MAX_BOXES = 8
    try:
        refs = {}
        for use_mesh in (False, True):
            jax_settings.USE_MESH = use_mesh
            jtab = JaxTableRec(checkpoint=os.devnull, tiny=True)
            jax_tables(jtab, n_rows=3, n_cols=2, n_cells=1)
            jpreds = (JaxDetection(checkpoint=os.devnull, tiny=True), JaxLayout(checkpoint=os.devnull, tiny=True),
                      jtab, JaxOCRError(checkpoint=os.devnull, tiny=True))
            assert all((p.mesh is not None) == use_mesh for p in jpreds)
            refs[use_mesh] = results(*jpreds)
        jax_settings.USE_MESH = False
        params = [jax.tree.map(np.asarray, p.params) for p in jpreds]
        ports = {}
        for m in (None, mesh):
            tab = TableRecPredictor(None, True, jax_params=params[2], device="cpu" if m is None else None, mesh=m)
            install_synthetic_tables(tab, n_rows=3, n_cols=2, n_cells=1)
            preds = (DetectionPredictor(None, True, jax_params=params[0], device="cpu" if m is None else None,
                                        mesh=m),
                     LayoutPredictor(None, True, jax_params=params[1], device="cpu" if m is None else None, mesh=m),
                     tab, OCRErrorPredictor(None, True, jax_params=params[3], device="cpu" if m is None else None,
                                            mesh=m))
            assert all(p.mesh is m for p in preds)
            ports[m is not None] = results(*preds)
    finally:
        jax_settings.USE_MESH = False
        jax_settings.TABLE_REC_MAX_BOXES, settings.TABLE_REC_MAX_BOXES = old

    for got in (ports[True], ports[False], refs[True]):
        det_boxes, labels, table, err_labels = got
        base_boxes, base_labels, base_table, base_err = refs[False]
        assert labels == base_labels and err_labels == base_err
        assert len(det_boxes) == len(base_boxes)
        for a, b in zip(det_boxes, base_boxes):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1
        assert len(table.rows) == len(base_table.rows) == 3 and len(table.cols) == len(base_table.cols) == 2
        assert len(table.cells) == len(base_table.cells)
        for a, b in zip(table.rows, base_table.rows):
            assert np.abs(np.asarray(a.polygon) - np.asarray(b.polygon)).max() < 1.0
    assert ports[True][0] == ports[False][0]  # detection boxes: the port's own unsharded ones exactly
