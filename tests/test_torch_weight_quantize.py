"""Int8 decoder weights (RECOGNITION_WEIGHT_QUANTIZE) in the port against
the JAX package, on the CPU:

- ``nn.quantize_linear`` gives surya_tpu's ``kernel_q`` and ``scale``
  exactly, from float32 and from bfloat16 weights, ties rounded half to even;
- a ``QuantLinear`` forward matches ``surya_tpu.nn.linear`` on the quantized
  pytree within 1e-5 relative in float32, and a cast of the module leaves
  the int8 weight and the float32 scale as they are;
- a tiny RecognitionPredictor on the JAX predictor's quantized weights
  (``from_jax_params`` of a tree with ``kernel_q`` leaves) decodes the JAX
  predictor's token ids, on given lines and on whole pages, with the bf16
  and the int8 KV cache;
- the random-weight path quantizes the weights it drew, and a float JAX
  pytree is quantized after loading when the setting is on;
- ``load_jax_params`` raises on a missing or an extra quantized leaf.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu import nn as jnn
from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch import nn as pnn
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.models import efficientvit, qwen_decoder
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.recognition.loader import from_jax_params, random_model, recognition_config
from surya_tpu_torch.recognition.tokenizer import ByteFallbackMathTokenizer, OCRTokenizer
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    from surya_tpu_torch.settings import settings as port_settings

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


PROJECTIONS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
               "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def weights(rng, out_dim=48, in_dim=40):
    """[out, in] float32 weights with a zero row and a row of exact .5 ties
    (scale 1: the ratios 0.5, 1.5, 2.5, -2.5 round to 0, 2, 2, -2)."""
    w = rng.standard_normal((out_dim, in_dim)).astype(np.float32) * 0.05
    w[3] = 0.0
    w[5] = 0.0
    w[5, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_linear_equals_jax(dtype):
    w = weights(np.random.default_rng(0))
    linear = torch.nn.Linear(w.shape[1], w.shape[0])
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(w))
        linear.bias.copy_(torch.from_numpy(np.arange(w.shape[0], dtype=np.float32)))
    linear = linear.to(getattr(torch, dtype))
    ref = jnn.quantize_linear({"kernel": jnp.asarray(w.T, getattr(jnp, dtype)),
                               "bias": jnp.asarray(np.arange(w.shape[0], dtype=np.float32), getattr(jnp, dtype))})
    q = pnn.quantize_linear(linear)
    assert q.weight_q.dtype == torch.int8 and q.scale.dtype == torch.float32
    np.testing.assert_array_equal(q.weight_q.numpy(), np.asarray(ref["kernel_q"]).T)
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(ref["scale"]))
    np.testing.assert_array_equal(q.weight_q[5, :5].numpy(), [127, 0, 2, 2, -2])
    assert (q.weight_q[3] == 0).all() and q.scale[3] == 0
    assert torch.equal(q.bias, linear.bias)


@pytest.mark.parametrize("bias", [True, False])
def test_quant_linear_forward_matches_jax(bias):
    rng = np.random.default_rng(1)
    w = weights(rng)
    p = {"kernel": jnp.asarray(w.T)}
    if bias:
        p["bias"] = jnp.asarray(rng.standard_normal(w.shape[0]).astype(np.float32))
    ref_q = jnn.quantize_linear(p)
    x = rng.standard_normal((3, 7, w.shape[1])).astype(np.float32)
    expected = np.asarray(jnn.linear(ref_q, jnp.asarray(x)))

    q = pnn.QuantLinear(w.shape[1], w.shape[0], bias=bias)
    pnn.load_jax_params(q, jax.tree.map(np.asarray, ref_q))
    with torch.no_grad():
        got = q(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5 * np.abs(expected).max())

    weight_q, scale = q.weight_q.clone(), q.scale.clone()
    q.to(dtype=torch.bfloat16)
    assert torch.equal(q.weight_q, weight_q) and torch.equal(q.scale, scale) and q.scale.dtype == torch.float32
    assert q(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_load_jax_params_raises_on_a_missing_or_extra_quantized_leaf():
    p = jax.tree.map(np.asarray, jnn.quantize_linear({"kernel": jnp.ones((8, 4)), "bias": jnp.zeros(4)}))
    q = pnn.QuantLinear(8, 4)
    pnn.load_jax_params(q, p)
    with pytest.raises(KeyError, match="scale"):
        pnn.load_jax_params(q, {"kernel_q": p["kernel_q"], "bias": p["bias"]})
    with pytest.raises(KeyError, match="kernel"):
        pnn.load_jax_params(q, {**p, "kernel": np.ones((8, 4), np.float32)})
    with pytest.raises(TypeError, match="int8"):
        pnn.load_jax_params(q, {**p, "kernel_q": p["kernel_q"].astype(np.float32)})
    # a decoder built without the swap has no buffer for the int8 leaves
    config = recognition_config(OCRTokenizer(math_tokenizer=ByteFallbackMathTokenizer()), tiny=True)
    with pytest.raises(KeyError, match="kernel_q"):
        pnn.load_jax_params(qwen_decoder.Decoder(config.decoder),
                            {"layers": [{"self_attn": {"q_proj": {"kernel_q": p["kernel_q"]}}}]})


def test_random_weights_are_quantized(monkeypatch):
    """The random-weight path swaps every projection of every layer and
    quantizes the weights it drew, after the cast to the model dtype."""
    monkeypatch.setattr(settings, "ALLOW_RANDOM_WEIGHTS", True)
    config = recognition_config(OCRTokenizer(math_tokenizer=ByteFallbackMathTokenizer()), tiny=True)
    monkeypatch.setattr(settings, "RECOGNITION_WEIGHT_QUANTIZE", False)
    plain = random_model(config, "cpu", dtype=torch.bfloat16)
    monkeypatch.setattr(settings, "RECOGNITION_WEIGHT_QUANTIZE", True)
    quant = random_model(config, "cpu", dtype=torch.bfloat16)
    for layer, ref_layer in zip(quant.decoder.layers, plain.decoder.layers):
        for name in PROJECTIONS:
            q, ref = layer.get_submodule(name), ref_layer.get_submodule(name)
            assert isinstance(q, pnn.QuantLinear) and q.scale.dtype == torch.float32
            expected = pnn.quantize_linear(ref)
            assert torch.equal(q.weight_q, expected.weight_q) and torch.equal(q.scale, expected.scale)
    assert not any(isinstance(m, pnn.QuantLinear) for m in quant.vision_encoder.modules())
    pred = RecognitionPredictor(None, True, device="cpu")
    assert isinstance(pred.model.decoder.layers[0].mlp.down_proj, pnn.QuantLinear)


def test_a_float_tree_is_quantized_under_the_setting(monkeypatch):
    """jax_params without int8 leaves and RECOGNITION_WEIGHT_QUANTIZE on:
    the weights are loaded, cast to the model dtype, then quantized, as the
    JAX loader quantizes a checkpoint's params."""
    tree = jax.tree.map(np.asarray, JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True).params)
    config = recognition_config(OCRTokenizer(math_tokenizer=ByteFallbackMathTokenizer()), tiny=True)
    monkeypatch.setattr(settings, "RECOGNITION_WEIGHT_QUANTIZE", False)
    plain = from_jax_params(tree, config, "cpu", dtype=torch.bfloat16)
    monkeypatch.setattr(settings, "RECOGNITION_WEIGHT_QUANTIZE", True)
    quant = from_jax_params(tree, config, "cpu", dtype=torch.bfloat16)
    for layer, ref_layer in zip(quant.decoder.layers, plain.decoder.layers):
        for name in PROJECTIONS:
            q, expected = layer.get_submodule(name), pnn.quantize_linear(ref_layer.get_submodule(name))
            assert torch.equal(q.weight_q, expected.weight_q) and torch.equal(q.scale, expected.scale)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX predictors with int8 decoder weights (the JAX loader
    quantizes at load) and the port's built from their pytrees."""
    old = jax_settings.RECOGNITION_WEIGHT_QUANTIZE, settings.RECOGNITION_WEIGHT_QUANTIZE
    jax_settings.RECOGNITION_WEIGHT_QUANTIZE = settings.RECOGNITION_WEIGHT_QUANTIZE = True
    try:
        jdet = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)  # a local path: random init
        jax_evit.install_blob_detector(jdet)
        jrec = JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True)
        det = DetectionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, jdet.params))
        efficientvit.install_blob_detector(det)
        rec = RecognitionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, jrec.params))
    finally:
        jax_settings.RECOGNITION_WEIGHT_QUANTIZE, settings.RECOGNITION_WEIGHT_QUANTIZE = old
    assert "kernel_q" in jrec.params["decoder"]["layers"][0]["mlp"]["up_proj"]
    assert isinstance(rec.model.decoder.layers[0].self_attn.q_proj, pnn.QuantLinear)
    return (jdet, jrec), (det, rec)


def _pages():
    pages = []
    for p in range(2):
        img = Image.new("RGB", (640, 480), "white")
        d = ImageDraw.Draw(img)
        for i in range(3 + p):
            d.text((20, 30 + i * 60), f"page {p} line {i} sample text", fill="black", font_size=22 + 4 * i)
        pages.append(img)
    return pages


def _token_ids(pred, call):
    """The token ids of every line that `call` recognizes, in order."""
    loop, runs = pred.prediction_loop, []

    def recording(*args, **kwargs):
        runs.append(loop(*args, **kwargs))
        return runs[-1]

    pred.prediction_loop = recording
    try:
        results = call(pred)
    finally:
        del pred.prediction_loop
    return results, [list(map(int, t)) for run in runs for t in run[0]]


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("path", ["given_lines", "whole_page"])
def test_int8_weights_recognition_matches_jax(pipelines, path, cache):
    (jdet, jrec), (det, rec) = pipelines
    pages = _pages()
    boxes = [[[10, 25, 420, 60], [10, 85, 400, 125]], [[10, 25, 420, 60], [10, 150, 460, 200], [20, 205, 300, 250]]]

    def call(pred, det_pred):
        if path == "given_lines":
            return lambda p: p([pg.copy() for pg in pages], bboxes=copy.deepcopy(boxes))
        return lambda p: p([pg.copy() for pg in pages], det_predictor=det_pred)

    old = jax_settings.RECOGNITION_MODEL_QUANTIZE, settings.RECOGNITION_MODEL_QUANTIZE
    jax_settings.RECOGNITION_MODEL_QUANTIZE = settings.RECOGNITION_MODEL_QUANTIZE = cache == "int8"
    try:
        expected, ref_ids = _token_ids(jrec, call(jrec, jdet))
        got, ids = _token_ids(rec, call(rec, det))
    finally:
        jax_settings.RECOGNITION_MODEL_QUANTIZE, settings.RECOGNITION_MODEL_QUANTIZE = old
    assert ids == ref_ids and sum(map(len, ids)) > 0
    assert [[ln.text for ln in p.text_lines] for p in got] == [[ln.text for ln in p.text_lines] for p in expected]
    assert [[ln.polygon for ln in p.text_lines] for p in got] == [[ln.polygon for ln in p.text_lines]
                                                                  for p in expected]
    if path == "whole_page":
        assert [len(p.text_lines) for p in got] == [3, 4]
