"""Shared CLI plumbing of the port's command-line tools, on argparse.

The option surface is the JAX package's (surya_tpu/scripts/config.py): a
positional ``input_path`` (a file or a folder of PDFs or images),
``--output_dir`` (default ``RESULT_DIR/surya``), ``--page_range`` ("0,5-10,20"),
``--images`` (save debug images) and ``--debug``/``-d``. Each CLI writes
``results.json`` under ``output_dir/<input name>``, keyed by input name, each
page a row with a 1-based ``page``.
"""

from __future__ import annotations

import argparse
import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from surya_tpu_torch.input.load import load_from_file, load_from_folder
from surya_tpu_torch.settings import settings


def _expand_range_part(part: str) -> List[int]:
    lo, dash, hi = part.partition("-")
    return list(range(int(lo), int(hi) + 1)) if dash else [int(lo)]


def _existing_path(value: str) -> str:
    if not Path(value).exists():
        raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
    return value


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the shared options; a CLI adds its own."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("input_path", type=_existing_path, help="A file or a folder of PDFs or images.")
    p.add_argument("--output_dir", default=str(Path(settings.RESULT_DIR) / "surya"),
                   help="Directory to save output.")
    p.add_argument("--page_range", default=None,
                   help="Page range, comma separated page numbers or ranges. Example: 0,5-10,20")
    p.add_argument("--images", action="store_true", help="Save images of detected bboxes.")
    p.add_argument("--debug", "-d", action="store_true", help="Enable debug mode.")
    return p


def parse_args(p: argparse.ArgumentParser, argv: Optional[Sequence[str]]) -> dict:
    """The parsed options as a dict; sets up logging (DEBUG with --debug)."""
    options = vars(p.parse_args(argv))
    logging.basicConfig(level=logging.DEBUG if options["debug"] else logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    return options


def parse_range_str(range_str: str) -> List[int]:
    pages = [p for part in range_str.split(",") for p in _expand_range_part(part)]
    return sorted(set(pages))


class CLILoader:
    """Resolves a CLI invocation (input path and shared options) into loaded
    page images, optional highres copies, names and a result directory."""

    parse_range_str = staticmethod(parse_range_str)

    def __init__(self, filepath: str, cli_options: dict, highres: bool = False):
        raw_range = cli_options.get("page_range")
        self.page_range = parse_range_str(raw_range) if raw_range else raw_range
        self.filepath = filepath
        self.config = cli_options
        self.save_images = cli_options.get("images", False)
        self.debug = cli_options.get("debug", False)
        self.output_dir = cli_options.get("output_dir")
        self.load(highres)

    def _read(self, dpi: int) -> Tuple[list, list]:
        reader = load_from_folder if Path(self.filepath).is_dir() else load_from_file
        return reader(self.filepath, self.page_range, dpi)

    def load(self, highres: bool = False):
        src = Path(self.filepath)
        self.images, self.names = self._read(settings.IMAGE_DPI)
        self.highres_images = self._read(settings.IMAGE_DPI_HIGHRES)[0] if highres else None
        run_name = src.name if src.is_dir() else src.name.split(".")[0]
        self.result_path = str((Path(self.output_dir) / run_name).absolute())
        Path(self.result_path).mkdir(parents=True, exist_ok=True)


def write_results_json(result_path: str, names, predictions, exclude=None, to_row=None) -> str:
    """Group per-image predictions into the results.json layout:
    {input_name: [prediction + 1-based "page", ...]}. `to_row` maps a
    prediction to its dict row (default: pydantic model_dump)."""
    if to_row is None:
        def to_row(pred):
            return pred.model_dump(exclude=exclude)
    by_name: dict = defaultdict(list)
    for name, pred in zip(names, predictions):
        row = to_row(pred)
        row["page"] = len(by_name[name]) + 1
        by_name[name].append(row)
    out = Path(result_path) / "results.json"
    out.write_text(json.dumps(by_name, ensure_ascii=False), encoding="utf-8")
    return str(out)


def save_page_artifacts(loader, predictions, render) -> None:
    """Render one debug artifact per page when --images was passed.
    `render(image, pred) -> (suffix, PIL image or None) pairs`."""
    if not loader.save_images:
        return
    for idx, (image, pred, name) in enumerate(zip(loader.images, predictions, loader.names)):
        for suffix, artifact in render(image, pred):
            if artifact is not None:
                artifact.save(str(Path(loader.result_path) / f"{name}_{idx}_{suffix}.png"))
