"""OCR error detection in the port against the JAX package, on the CPU in
float32, on shared weights (carried over with ocr_error.from_jax_params):

- the tiny DistilBERT's logits against ``surya_tpu.models.distilbert.apply``
  within 1e-4 relative, at lengths of two sequence buckets with padded rows;
- ``OCRErrorPredictor`` against the JAX predictor: the same labels, with
  both given a WordPieceTokenizer on the same vocab, over batches that end
  with a partial one;
- the port's tokenizer gives the JAX tokenizer's ids whenever a vocab is
  given, and in its fallback (no vocab) the same ids in two processes with
  different PYTHONHASHSEEDs.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import distilbert as jax_distilbert
from surya_tpu.ocr_error import OCRErrorPredictor as JaxOCRErrorPredictor
from surya_tpu.ocr_error.tokenizer import WordPieceTokenizer as JaxWordPieceTokenizer
from surya_tpu_torch.common.predictor import row_bucket
from surya_tpu_torch.models.distilbert import DistilBertConfig
from surya_tpu_torch.ocr_error import SEQ_BUCKETS, OCRErrorPredictor, from_jax_params
from surya_tpu_torch.ocr_error.tokenizer import WordPieceTokenizer

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


TINY = dict(n_layers=2, n_heads=4, dim=64, hidden_dim=128)
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox", "jump", "##s", "over", "lazy", "dog",
         "th", "##3", "qu", "##1", "##ck", "br", "##0", "##wn", "f", "##x", "0", "##v", "##r", ".", ",", "!",
         "cafe", "naive", "hello", "world", "##ld", "wor", "a", "b", "c", "1", "2", "3"]
VOCAB = {w: i for i, w in enumerate(WORDS)}
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Th3 qu1ck br0wn f0x jumps 0v3r",
    "Café naïve, HELLO world!",
    "\x00control\tchars\r\nand   spaces",
    "",
    "x" * 150 + " dog",
    "a b c 1 2 3 " * 12,
    "unknownword zzz",
    "hello world",
    "brown dog, lazy fox!",
    "over over over",
]


def perturbed(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * scale, params)


@pytest.fixture(scope="module")
def shared():
    """A JAX tiny pytree with every leaf perturbed (biases and norms too), the
    head's spread widened, and the "bad" bias set midway between two of the
    texts' logit margins, so that both labels occur and none is near a tie."""
    cfg = jax_distilbert.DistilBertConfig(**TINY)
    params = perturbed(jax_distilbert.init_params(cfg, jax.random.PRNGKey(3)), 4, 0.05)
    params["pre_classifier"] = perturbed(params["pre_classifier"], 5, 0.5)
    params["classifier"] = perturbed(params["classifier"], 6, 1.0)
    enc = JaxWordPieceTokenizer(vocab=dict(VOCAB))(TEXTS)
    logits = np.asarray(jax_distilbert.apply(params, cfg, jnp.asarray(enc["input_ids"]),
                                             jnp.asarray(enc["attention_mask"])))
    margins = np.sort(logits[:, 1] - logits[:, 0])
    params["classifier"]["bias"][1] -= (margins[5] + margins[6]) / 2
    return cfg, params


def test_distilbert_logits_match_jax(shared):
    cfg, params = shared
    model = from_jax_params(params, DistilBertConfig(**TINY), "cpu")
    rng = np.random.default_rng(6)
    for S in (64, 128):  # two sequence buckets
        ids = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
        mask = np.ones((3, S), np.int32)
        mask[1, S // 2:] = 0
        mask[2, 7:] = 0
        expected = np.asarray(jax_distilbert.apply(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
        with torch.inference_mode():
            got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4 * np.abs(expected).max())


def test_predictor_labels_match_jax(shared):
    _, params = shared
    ref = JaxOCRErrorPredictor(checkpoint=os.devnull, tiny=True)  # a local path: random init, no download
    ref.params = jax.tree.map(jnp.asarray, params)
    ref.processor = JaxWordPieceTokenizer(vocab=dict(VOCAB))
    ours = OCRErrorPredictor(None, True, device="cpu", jax_params=params)
    ours.processor = WordPieceTokenizer(vocab=dict(VOCAB))
    expected = ref(TEXTS, batch_size=4)
    got = ours(TEXTS, batch_size=4)
    assert got.texts == TEXTS and got.labels == expected.labels
    assert set(got.labels) == {"good", "bad"}
    # the second batch holds a text of 74 tokens; the last batch's 3 texts run as 4 rows
    assert ours.last_run["batches"] == [(4, 64), (4, 128), (4, 64)]
    assert ours([]).labels == []


def test_row_and_sequence_buckets():
    assert [row_bucket(n, 8) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    assert row_bucket(5, 6) == 6
    assert SEQ_BUCKETS == (64, 128, 256, 512)


def test_tokenizer_ids_equal_jax_with_a_vocab():
    ours, ref = WordPieceTokenizer(vocab=dict(VOCAB)), JaxWordPieceTokenizer(vocab=dict(VOCAB))
    for text in TEXTS:
        assert ours.encode(text) == ref.encode(text)
        assert ours.encode(text, max_length=8) == ref.encode(text, max_length=8)
    assert ours(TEXTS) == ref(TEXTS)


FALLBACK = (
    "import json, sys; from surya_tpu_torch.ocr_error.tokenizer import WordPieceTokenizer; "
    "print(json.dumps([WordPieceTokenizer().encode(t) for t in json.loads(sys.argv[1])]))"
)


def test_fallback_ids_do_not_depend_on_the_hash_seed():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ids = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        proc = subprocess.run([sys.executable, "-c", FALLBACK, json.dumps(TEXTS)], cwd=root, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        ids.append(json.loads(proc.stdout))
    assert ids[0] == ids[1] == [WordPieceTokenizer().encode(t) for t in TEXTS]
    specials = WordPieceTokenizer().encode("")
    assert specials == [101, 102]
    assert all(1000 <= i < 30522 for row in ids[0] for i in row[1:-1] if i != 100)
