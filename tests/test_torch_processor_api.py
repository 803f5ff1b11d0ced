"""The last public methods of the port's recognition processor, OCR
tokenizer and encoder config against the JAX package's, on the same numpy
inputs: ``align_long_axis``, ``image_processor``, ``build_prompt_ids``
with ``rotated``, ``decode``, ``OCRTokenizer.__call__`` and
``EncoderConfig.window_patches``; the prompt-id cache keyed on ``rotated``;
and every public method, property and attribute of the JAX classes present
on the port's."""

import numpy as np
import pytest
from PIL import Image

from surya_tpu.models.qwen_encoder import EncoderConfig as JaxEncoderConfig
from surya_tpu.recognition.processor import RecognitionProcessor as JaxProcessor
from surya_tpu.recognition.tokenizer import OCRTokenizer as JaxTokenizer
from surya_tpu_torch.models.qwen_encoder import EncoderConfig
from surya_tpu_torch.recognition.loader import DEFAULT_ENCODER, TINY_ENCODER
from surya_tpu_torch.recognition.processor import RecognitionProcessor
from surya_tpu_torch.recognition.tokenizer import TASK_NAMES, OCRTokenizer, TaskNames

TEXTS = ["Hello, World!", "héllo ünïcode", "日本語テスト", "<b>bold</b> text", "<math>x^2 + y_1</math> end"]
MATH_TEXT = "E = mc^2"


@pytest.fixture(scope="module")
def processors():
    return JaxProcessor(JaxTokenizer()), RecognitionProcessor(OCRTokenizer())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(100, 40), (40, 100), (64, 64)], ids=["tall", "wide", "square"])
def test_align_long_axis_matches_jax(processors, shape, dtype):
    jax_proc, proc = processors
    image = (np.random.default_rng(0).random((*shape, 3)) * 255).astype(dtype)
    ref, ref_rotated = jax_proc.align_long_axis(image.copy())
    out, rotated = proc.align_long_axis(image.copy())
    assert rotated == ref_rotated == (shape[0] > shape[1])
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out, ref)
    if rotated:  # counter-clockwise: the first column becomes the last row
        assert np.array_equal(out[-1], image[:, 0])


def test_image_processor_matches_jax(processors):
    jax_proc, proc = processors
    page = Image.fromarray((np.random.default_rng(1).random((90, 70, 3)) * 255).astype(np.uint8), "RGB")
    out, ref = proc.image_processor(page), jax_proc.image_processor(page)
    assert out.dtype == np.uint8 == ref.dtype
    assert out.shape == (90, 70, 3) and np.array_equal(out, ref)


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("math_mode", [False, True])
@pytest.mark.parametrize("task", TASK_NAMES)
def test_build_prompt_ids_matches_jax(processors, task, math_mode, rotated):
    jax_proc, proc = processors
    texts = [None, ""] + ([MATH_TEXT] if task == TaskNames.block_without_boxes else TEXTS)
    for n_tok in (1, 12):
        for text in texts:
            ids = proc.build_prompt_ids(task, n_tok, text, math_mode, rotated=rotated)
            assert ids == jax_proc.build_prompt_ids(task, n_tok, text, math_mode, rotated=rotated)
            assert (ids[0] == proc.image_rotated_token) == rotated


@pytest.mark.parametrize("task", TASK_NAMES)
def test_decode_matches_jax(processors, task):
    """Id lists that mix text, system ids (PAD, EOS, registers, <ROT>), math
    and formatting tags and -100: the same string."""
    jax_proc, proc = processors
    tok = proc.tokenizer
    system = list(tok.system_tokens.values())
    texts = [MATH_TEXT] if task == TaskNames.block_without_boxes else TEXTS
    rng = np.random.default_rng(2)
    for text in texts:
        ids = tok.encode(text, task=task)
        mixed = []
        for i in ids:
            mixed.append(i)
            if rng.random() < 0.4:
                mixed.append(int(rng.choice(system)) if rng.random() < 0.7 else -100)
        mixed = [proc.image_rotated_token, -100] + mixed + [proc.eos_token_id, proc.pad_token_id]
        out = proc.decode(mixed, task)
        assert out == jax_proc.decode(mixed, task)
        assert out == tok.decode(ids, task=task)  # only the system ids and -100 went


@pytest.mark.parametrize("task", [TaskNames.ocr_with_boxes, TaskNames.block_without_boxes])
def test_tokenizer_call_matches_jax(task):
    """A string is a list of one; lists pair each text with its task."""
    tok, jax_tok = OCRTokenizer(), JaxTokenizer()
    text = MATH_TEXT if task == TaskNames.block_without_boxes else TEXTS[0]
    single = tok(text, task)
    assert single == jax_tok(text, task) == {"input_ids": [tok.encode(text, task=task)]}
    texts = TEXTS if task == TaskNames.ocr_with_boxes else [MATH_TEXT, "a + b", ""]
    tasks = [task] * len(texts)
    batch = tok(texts, tasks)
    assert batch == jax_tok(texts, tasks)
    assert batch["input_ids"] == [tok.encode(t, task=task) for t in texts]
    mixed = tok([TEXTS[3], MATH_TEXT], [TaskNames.ocr_without_boxes, task])
    assert mixed == jax_tok([TEXTS[3], MATH_TEXT], [TaskNames.ocr_without_boxes, task])


def test_tokenizer_call_without_task_fails_as_jax():
    """A single string without its task fails in both: None is no task."""
    for tok in (OCRTokenizer(), JaxTokenizer()):
        with pytest.raises(AssertionError, match="invalid task"):
            tok("Hello")


@pytest.mark.parametrize("config", [DEFAULT_ENCODER, TINY_ENCODER], ids=["default", "tiny"])
def test_window_patches_matches_jax(config):
    ours, ref = EncoderConfig(**config), JaxEncoderConfig(**config)
    assert ours.window_patches == ref.window_patches == ours.window_cells**2 * ours.merge_unit
    if config is DEFAULT_ENCODER:
        assert ours.window_patches == 64  # 4 x 4 cells of 2 x 2 patches


def test_cached_prompt_ids_keys_on_rotated():
    """The same (task, tokens, text, math) key with and without rotated gives
    two prompts, each its build_prompt_ids, in either order of first use."""
    for first in (False, True):
        proc = RecognitionProcessor(OCRTokenizer())
        key = (TaskNames.ocr_with_boxes, 6, "Hello", True)
        a = proc._cached_prompt_ids(*key, rotated=first)
        b = proc._cached_prompt_ids(*key, rotated=not first)
        assert a != b
        assert a == proc.build_prompt_ids(*key, rotated=first)
        assert b == proc.build_prompt_ids(*key, rotated=not first)
        assert proc._cached_prompt_ids(*key) == proc.build_prompt_ids(*key)
        assert proc._cached_prompt_ids(*key, rotated=True)[0] == proc.image_rotated_token


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


@pytest.mark.parametrize("name", ["RecognitionProcessor", "OCRTokenizer", "EncoderConfig"])
def test_port_has_every_public_name_of_jax(name):
    """Every public method, property and instance attribute of the JAX class
    exists on the port's, with the same plain values (and OCRTokenizer's
    __call__)."""
    jax_tok, tok = JaxTokenizer(), OCRTokenizer()
    jax_obj, obj = {
        "RecognitionProcessor": (JaxProcessor(jax_tok), RecognitionProcessor(tok)),
        "OCRTokenizer": (jax_tok, tok),
        "EncoderConfig": (JaxEncoderConfig(), EncoderConfig()),
    }[name]
    missing = sorted(_public(type(jax_obj)) - _public(type(obj)))
    assert not missing, f"the port's {name} lacks {missing}"
    missing = sorted(_public(jax_obj) - _public(obj))
    assert not missing, f"the port's {name} instance lacks {missing}"
    # the plain values (token ids, widths, tags) are equal too
    plain = (int, float, str, bool, list, tuple, dict)
    differ = sorted(n for n in _public(jax_obj) if isinstance(getattr(jax_obj, n), plain)
                    and getattr(obj, n) != getattr(jax_obj, n))
    assert not differ, f"the port's {name} differs in {differ}"
    if name == "OCRTokenizer":
        assert callable(obj)
