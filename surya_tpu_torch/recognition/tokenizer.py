"""Three-regime OCR tokenizer (the port's copy of surya_tpu/recognition/tokenizer.py;
that module's package imports jax).

Token id space (low → high):
  [0, qwen_offset)                      math-mode BPE ids (Qwen2 tokenizer)
  [qwen_offset, qwen_offset + n_spec)   special tags (system/formatting/math)
  [qwen_offset + n_spec, ... + 65536)   UTF-16 code units for general text

The real id layout comes from the checkpoint: its Qwen2 tokenizer files
(``QwenMathTokenizer``) and config.json's special_ocr_tokens. With random
weights a byte-level fallback stands in for the Qwen2 BPE and the default
special-token list is used; the id arithmetic is the JAX package's.
"""

from __future__ import annotations

import html
import re
from typing import Dict, List, Sequence

# Task-agnostic token strings (reference: processor/__init__.py:26-39)
EOS_TOKEN = "</S>"
EOI_TOKEN = "<EOI>"
IMAGE_TOKEN = "<IMAGE>"
PAD_TOKEN = "<PAD>"
NO_OUTPUT_TOKEN = "<NOP>"
IMAGE_ROTATED_TOKEN = "<ROT>"
REGISTER_TOKENS = ["<REG1>", "<REG2>", "<REG3>", "<REG4>"]
NOMATH_TOKEN = "<NO-MATH>"
OCR_WITH_BOXES_BOS_TOKEN = "<OCR-WB>"
OCR_WITHOUT_BOXES_BOS_TOKEN = "<OCR-WOB>"
BLOCK_WITHOUT_BOXES_TOKEN = "<BLOCKS-WOB>"


class TaskNames:
    block_without_boxes = "block_without_boxes"
    ocr_with_boxes = "ocr_with_boxes"
    ocr_without_boxes = "ocr_without_boxes"


TASK_NAMES = [
    TaskNames.block_without_boxes,
    TaskNames.ocr_with_boxes,
    TaskNames.ocr_without_boxes,
]

_DEFAULT_SYSTEM = [
    EOS_TOKEN,
    EOI_TOKEN,
    IMAGE_TOKEN,
    PAD_TOKEN,
    NO_OUTPUT_TOKEN,
    IMAGE_ROTATED_TOKEN,
    *REGISTER_TOKENS,
    NOMATH_TOKEN,
    OCR_WITH_BOXES_BOS_TOKEN,
    OCR_WITHOUT_BOXES_BOS_TOKEN,
    BLOCK_WITHOUT_BOXES_TOKEN,
]
_DEFAULT_FORMATTING = [
    "<b>", "</b>", "<i>", "</i>", "<u>", "</u>", "<del>", "</del>",
    "<mark>", "</mark>", "<sup>", "</sup>", "<sub>", "</sub>", "<br>",
]
_DEFAULT_MATH = ["<math>", '<math display="block">', '<math display="inline">', "</math>"]

DEFAULT_SPECIAL_TOKENS: Dict[str, list] = {
    "system": _DEFAULT_SYSTEM,
    "formatting": _DEFAULT_FORMATTING,
    "math_external": _DEFAULT_MATH,
    "all": _DEFAULT_SYSTEM + _DEFAULT_FORMATTING + _DEFAULT_MATH,
}


def _token_regex(tokens: Sequence[str]) -> re.Pattern:
    escaped = sorted((re.escape(t) for t in tokens), key=len, reverse=True)
    return re.compile(r"^(" + "|".join(escaped) + r")")


class ByteFallbackMathTokenizer:
    """Offline stand-in for the checkpoint's Qwen2 BPE: UTF-8 bytes as ids."""

    def __len__(self):
        return 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(max(0, min(i, 255)) for i in ids).decode("utf-8", errors="ignore")


class QwenMathTokenizer:
    """The HF Qwen2 tokenizer shipped inside the checkpoint directory
    (``vocab.json``, ``merges.txt``); ``transformers`` is imported only here."""

    def __init__(self, ckpt_dir: str):
        from transformers import Qwen2Tokenizer

        self._tok = Qwen2Tokenizer.from_pretrained(ckpt_dir)

    def __len__(self):
        return len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok(text)["input_ids"]

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids)


class OCRTokenizer:
    """Port of InnerOCRTokenizer + SuryaOCRTokenizer (reference
    tokenizer.py:27-320) with identical id arithmetic and regex precedence:
    system tags → math tags → math-mode BPE → formatting tags → UTF-16."""

    MATH_TAG_START = "<math"
    MATH_END_TAG = "</math>"

    def __init__(self, special_tokens: Dict[str, list] | None = None, math_tokenizer=None):
        self.special_tokens = special_tokens or DEFAULT_SPECIAL_TOKENS
        self.math_tokenizer = math_tokenizer or ByteFallbackMathTokenizer()
        self.qwen_offset = len(self.math_tokenizer)

        self.SPECIAL_TOKEN_MAPPING: Dict[str, int] = {}
        for i, tag in enumerate(dict.fromkeys(self.special_tokens.get("all", []))):
            self.SPECIAL_TOKEN_MAPPING[tag] = i + self.qwen_offset
        self.REVERSE_SPECIAL_TOKEN_MAPPING = {v: k for k, v in self.SPECIAL_TOKEN_MAPPING.items()}
        self.SPECIAL_TOKEN_OFFSET = len(self.SPECIAL_TOKEN_MAPPING)
        self.special_token_offset = self.qwen_offset + self.SPECIAL_TOKEN_OFFSET

        self.FORMAT_TAG_PATTERN = _token_regex(self.special_tokens["formatting"])
        self.MATH_TAG_PATTERN = _token_regex(self.special_tokens["math_external"])
        self.SYSTEM_TAG_PATTERN = _token_regex(self.special_tokens.get("system", []))

        self.system_tokens = {
            t: self.SPECIAL_TOKEN_MAPPING[t] for t in self.special_tokens.get("system", [])
        }

    @property
    def vocab_size(self) -> int:
        # 65536 utf-16 code units + specials + math BPE ids
        return self.qwen_offset + self.SPECIAL_TOKEN_OFFSET + 65536

    # -- encoding ------------------------------------------------------------

    def text_to_utf16_numbers(self, text: str) -> List[int]:
        raw = text.encode("utf-16le")
        return [raw[i] | (raw[i + 1] << 8) for i in range(0, len(raw), 2)]

    def utf16_numbers_to_text(self, numbers: List[int]) -> str:
        raw = bytearray()
        for n in numbers:
            raw.append(n & 0xFF)
            raw.append((n >> 8) & 0xFF)
        return raw.decode("utf-16le", errors="ignore")

    def _tokenize_ocr(self, text: str) -> List[int]:
        tokens: List[int] = []
        in_math = False
        text = html.unescape(text)
        while text:
            match = self.SYSTEM_TAG_PATTERN.search(text)
            if match:
                tokens.append(self.SPECIAL_TOKEN_MAPPING[match.group(1)])
                text = text[match.end():]
                continue

            match = self.MATH_TAG_PATTERN.search(text)
            if match:
                tag = match.group(1)
                if tag.startswith(self.MATH_TAG_START):
                    in_math = True
                elif tag == self.MATH_END_TAG:
                    in_math = False
                tokens.append(self.SPECIAL_TOKEN_MAPPING[tag])
                text = text[match.end():]
                continue

            if in_math:
                end = text.find(self.MATH_END_TAG)
                tokens += self.math_tokenizer.encode(text[:end])
                text = text[end:]
                continue

            match = self.FORMAT_TAG_PATTERN.search(text)
            if match:
                tokens.append(self.SPECIAL_TOKEN_MAPPING[match.group(1)])
                text = text[match.end():]
                continue

            tokens += [t + self.special_token_offset for t in self.text_to_utf16_numbers(text[0])]
            text = text[1:]
        return tokens

    def encode(self, text: str, task: str = TaskNames.ocr_with_boxes) -> List[int]:
        assert task in TASK_NAMES, f"invalid task {task}"
        if task == TaskNames.block_without_boxes:
            return self.math_tokenizer.encode(text)
        return self._tokenize_ocr(text)

    # -- decoding ------------------------------------------------------------

    def _decode_ocr(self, token_ids: List[int]) -> str:
        out = []
        buffer: List[int] = []
        buffer_is_math = False

        def flush():
            nonlocal buffer, buffer_is_math
            if buffer:
                if buffer_is_math:
                    out.append(self.math_tokenizer.decode(buffer))
                else:
                    out.append(
                        self.utf16_numbers_to_text([t - self.special_token_offset for t in buffer])
                    )
            buffer = []
            buffer_is_math = False

        for t in token_ids:
            if t < self.qwen_offset:  # math BPE segment
                if buffer and buffer[-1] >= self.qwen_offset:
                    flush()
                buffer.append(t)
                buffer_is_math = True
            elif t >= self.special_token_offset:  # utf-16 segment
                if buffer and buffer[-1] < self.qwen_offset:
                    flush()
                buffer.append(t)
                buffer_is_math = False
            elif t in self.REVERSE_SPECIAL_TOKEN_MAPPING:
                flush()
                out.append(self.REVERSE_SPECIAL_TOKEN_MAPPING[t])
            else:
                raise ValueError(f"unexpected token {t} while decoding")
        flush()
        return "".join(out)

    def decode(self, token_ids, task: str = TaskNames.ocr_with_boxes) -> str:
        assert task in TASK_NAMES, f"invalid task {task}"
        token_ids = list(token_ids)
        if task == TaskNames.block_without_boxes:
            return self.math_tokenizer.decode(token_ids)
        return self._decode_ocr(token_ids)
