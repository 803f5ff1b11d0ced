"""Per-language Noto font resolution for the PIL debug text renderer (the
port's copy of surya_tpu/debug/fonts.py). Fonts are fetched at first use
into settings.FONT_DIR; where they cannot be, get_font_path returns None and
the renderer falls back to PIL's default font."""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from surya_tpu_torch.settings import settings

logger = logging.getLogger(__name__)


def get_font_path(langs: Optional[List[str]] = None) -> Optional[str]:
    """Resolve (and lazily download) the render font for `langs`. Returns a
    filesystem path, or None when the font can't be fetched."""
    name = settings.RECOGNITION_RENDER_FONTS["all"]
    if langs is not None and len(langs) == 1:
        name = settings.RECOGNITION_RENDER_FONTS.get(langs[0], name)

    font_path = os.path.join(settings.FONT_DIR, name)
    if os.path.exists(font_path):
        return font_path

    try:
        import requests

        os.makedirs(settings.FONT_DIR, exist_ok=True)
        url = f"{settings.RECOGNITION_FONT_DL_BASE}/{name}"
        with requests.get(url, stream=True, timeout=30) as r:
            r.raise_for_status()
            tmp = font_path + ".tmp"
            with open(tmp, "wb") as f:
                for chunk in r.iter_content(chunk_size=8192):
                    f.write(chunk)
            os.replace(tmp, font_path)
        return font_path
    except Exception as e:
        logger.warning("render font %s unreachable (%s); using PIL default", name, e)
        return None
