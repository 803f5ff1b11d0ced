"""WordPiece tokenizer for the OCR-error DistilBERT (the port's copy of
surya_tpu/ocr_error/tokenizer.py).

Loads a vocab.txt; without one (random-weight mode) it falls back to a hash
vocabulary with the same special-token layout. The fallback hashes with
CRC-32 of the token's UTF-8 bytes, so a text gets the same ids in every
process; the JAX package's ``hash()`` is salted per process
(PYTHONHASHSEED). With a vocab the ids are the JAX tokenizer's.
"""

from __future__ import annotations

import os
import unicodedata
import zlib
from typing import Dict, List, Optional


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    def __init__(self, vocab: Optional[Dict[str, int]] = None, do_lower_case: bool = True, max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk_token = "[UNK]"
        self.cls_token = "[CLS]"
        self.sep_token = "[SEP]"
        self.pad_token = "[PAD]"
        self._fallback_size = 30522

    @classmethod
    def from_pretrained(cls, ckpt_dir: str) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(os.path.join(ckpt_dir, "vocab.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab=vocab)

    # -- pieces --------------------------------------------------------------

    def _token_id(self, token: str) -> int:
        if self.vocab is not None:
            return self.vocab.get(token, self.vocab.get(self.unk_token, 100))
        specials = {self.pad_token: 0, self.unk_token: 100, self.cls_token: 101, self.sep_token: 102}
        if token in specials:
            return specials[token]
        # a stable hash into the non-special id range
        return 1000 + (zlib.crc32(token.encode("utf-8", "surrogatepass")) % (self._fallback_size - 1000))

    def _basic_tokenize(self, text: str) -> List[str]:
        out = []
        cleaned = []
        for ch in text:
            if ord(ch) == 0 or ord(ch) == 0xFFFD or _is_control(ch):
                continue
            cleaned.append(" " if _is_whitespace(ch) else ch)
        text = "".join(cleaned)

        for word in text.strip().split():
            if self.do_lower_case:
                word = word.lower()
                word = "".join(c for c in unicodedata.normalize("NFD", word) if unicodedata.category(c) != "Mn")
            # split on punctuation
            current = []
            for ch in word:
                if _is_punctuation(ch):
                    if current:
                        out.append("".join(current))
                        current = []
                    out.append(ch)
                else:
                    current.append(ch)
            if current:
                out.append("".join(current))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        if self.vocab is None:
            return [word]  # fallback: whole-word hashing
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        tokens = [self.cls_token]
        for word in self._basic_tokenize(text):
            tokens.extend(self._wordpiece(word))
        tokens = tokens[: max_length - 1] + [self.sep_token]
        return [self._token_id(t) for t in tokens]

    def __call__(self, texts: List[str], max_length: int = 512):
        """Batch encode with longest-padding; returns dict of lists."""
        encoded = [self.encode(t, max_length) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        pad_id = self._token_id(self.pad_token)
        input_ids = [e + [pad_id] * (longest - len(e)) for e in encoded]
        attention_mask = [[1] * len(e) + [0] * (longest - len(e)) for e in encoded]
        return {"input_ids": input_ids, "attention_mask": attention_mask}
