"""Text postprocessing (the port's copy of surya_tpu/recognition/postprocessing.py)."""

from __future__ import annotations

import re
from typing import Dict, List

from surya_tpu_torch.recognition.schema import TextChar

TAG_PATTERN = re.compile(r"<(/?)([a-z]+)([^>]*)>?", re.IGNORECASE)


def truncate_repetitions(text: str, min_len: int = 15) -> str:
    """Trim a repeating tail down to one repetition (nougat-style;
    reference :7-35)."""
    if len(text) < 2 * min_len:
        return text

    max_rep_len = None
    for rep_len in range(min_len, len(text) // 2):
        if all(text[len(text) - rep_len - i - 1] == text[len(text) - i - 1] for i in range(rep_len)):
            max_rep_len = rep_len

    if max_rep_len is None:
        return text

    lcs = text[-max_rep_len:]
    trimmed = text
    while trimmed.endswith(lcs):
        trimmed = trimmed[:-max_rep_len]
    return text[: len(trimmed)]


def extract_tags(proposed_tags: List[str]) -> List[str]:
    tags = []
    for tag in proposed_tags:
        m = re.match(TAG_PATTERN, tag)
        if m and m.group(1) == "/":
            tags.append(m.group(2))
    return tags


def fix_unbalanced_tags(text_chars: List[TextChar], special_tokens: Dict[str, list]) -> List[TextChar]:
    """Append closing chars for dangling format/math tags (reference :76-121)."""
    self_closing = ["br"]
    open_tags: List[str] = []
    format_tags = None  # read at the first tag: most lines have none

    for char in text_chars:
        if len(char.text) <= 1:
            continue
        m = re.match(TAG_PATTERN, char.text)
        if not m:
            continue
        if format_tags is None:
            format_tags = extract_tags(special_tokens["formatting"]) + extract_tags(special_tokens["math_external"])
        is_closing = m.group(1) == "/"
        name = m.group(2).lower()
        if name not in format_tags or name in self_closing:
            continue
        if m.group(3) and m.group(3).strip().endswith("/"):
            continue
        if is_closing:
            if open_tags and open_tags[-1] == name:
                open_tags.pop()
        else:
            open_tags.append(name)

    for tag in open_tags:
        text_chars.append(
            TextChar(text=f"</{tag}>", confidence=0, polygon=[[0, 0], [1, 0], [1, 1], [0, 1]], bbox_valid=False)
        )
    return text_chars
