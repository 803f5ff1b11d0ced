"""Metrics, scoring, data and score gates of the port's accuracy stages,
and what every stage shares: its options, its result file and the
plain-text table it prints."""

import argparse
import json
import os
from typing import Sequence

from surya_tpu_torch.settings import settings


def _cell(value) -> str:
    return format(value, "g") if isinstance(value, float) else str(value)


def format_table(rows: Sequence[Sequence], headers: Sequence[str]) -> str:
    """A plain-text table: a header line, a rule, one line a row; numbers
    right-aligned, text left-aligned, floats in ``g`` format."""
    cells = [[_cell(v) for v in row] for row in rows]
    numeric = [all(isinstance(row[i], (int, float)) for row in rows) for i in range(len(headers))]
    widths = [max([len(h)] + [len(row[i]) for row in cells]) for i, h in enumerate(headers)]

    def line(values):
        return "  ".join(v.rjust(w) if num else v.ljust(w) for v, w, num in zip(values, widths, numeric)).rstrip()

    return "\n".join([line(headers), line(["-" * w for w in widths])] + [line(row) for row in cells])


def stage_parser(description: str, max_rows: int):
    """The options of every stage: ``--results_dir`` (default
    ``RESULT_DIR/benchmark``), ``--max_rows`` and ``--synthetic``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--results_dir", default=os.path.join(settings.RESULT_DIR, "benchmark"))
    p.add_argument("--max_rows", type=int, default=max_rows)
    p.add_argument("--synthetic", action="store_true", help="Use synthetic pages (no dataset download).")
    return p


def write_results(results_dir: str, name: str, out: dict) -> None:
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, name), "w") as f:
        json.dump(out, f, indent=2)
