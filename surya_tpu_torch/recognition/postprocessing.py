"""Text postprocessing (the port's copy of surya_tpu/recognition/postprocessing.py)."""

from __future__ import annotations

import re
from typing import Dict, List

from surya_tpu_torch.recognition.schema import TextChar

TAG_PATTERN = re.compile(r"<(/?)([a-z]+)([^>]*)>?", re.IGNORECASE)


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
    format_tags = extract_tags(special_tokens["formatting"]) + extract_tags(special_tokens["math_external"])

    for char in text_chars:
        if len(char.text) <= 1:
            continue
        m = re.match(TAG_PATTERN, char.text)
        if not m:
            continue
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
