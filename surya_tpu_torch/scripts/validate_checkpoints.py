"""One command between "checkpoints are reachable" and "accuracy proven"
(counterpart of surya_tpu/scripts/validate_checkpoints.py, on argparse).

Builds every predictor through the normal loaders (the ``*_MODEL_CHECKPOINT``
settings), runs the six accuracy stages of ``surya_tpu_torch/benchmark``
(detection, recognition, layout, reading order, table recognition, texify)
and applies the reference's CI score gates
(the port's copy, ``benchmark/utils/verify_benchmark_scores.py``). Writes
``validation_summary.json`` beside the stages' result files, prints the
summary, and exits non-zero with ``gates failed: ...`` when a gate fails.
Outside ``--smoke`` it refuses to run under ALLOW_RANDOM_WEIGHTS. The real
gates need the stages' Hugging Face datasets and the checkpoints.

``--smoke`` is the offline plumbing check: the stages that have synthetic
pages (detection, recognition, table recognition) run on them, the others
are skipped, and a score below a gate is reported but does not fail the run.

    python -m surya_tpu_torch.scripts.validate_checkpoints [--results_dir DIR] [--max_rows N]
        [--only GATE ...] [--smoke]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
from typing import Optional, Sequence

from surya_tpu_torch.benchmark.utils.verify_benchmark_scores import VERIFIERS
from surya_tpu_torch.logging import get_logger
from surya_tpu_torch.settings import settings

logger = get_logger()

# (module, result file, gate name, supports --synthetic)
STAGES = [
    ("surya_tpu_torch.benchmark.detection", "det_bench.json", "detection", True),
    ("surya_tpu_torch.benchmark.recognition", "rec_bench.json", "recognition", True),
    ("surya_tpu_torch.benchmark.layout", "layout_bench.json", "layout", False),
    ("surya_tpu_torch.benchmark.ordering", "order_bench.json", "ordering", False),
    ("surya_tpu_torch.benchmark.table_recognition", "table_rec_bench.json", "table_recognition", True),
    ("surya_tpu_torch.benchmark.texify", "texify_bench.json", "texify", False),
]


def run_stage(mod_name: str, results_dir: str, max_rows, synthetic: bool):
    """Runs a stage with its own option defaults, but these three."""
    mod = importlib.import_module(mod_name)
    kwargs = vars(mod.parser().parse_args([]))
    kwargs["results_dir"] = results_dir
    if max_rows is not None:
        kwargs["max_rows"] = max_rows
    if "synthetic" in kwargs:
        kwargs["synthetic"] = synthetic
    mod.run(**kwargs)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Load the checkpoints, run all benchmarks, apply the reference score "
                                            "gates.")
    p.add_argument("--results_dir", default=os.path.join(settings.RESULT_DIR, "benchmark"))
    p.add_argument("--max_rows", type=int, default=None, help="Limit rows per benchmark (CI smoke uses 2-5).")
    p.add_argument("--only", action="append", default=[],
                   help="Run only these gates (e.g. --only detection --only recognition).")
    p.add_argument("--smoke", action="store_true",
                   help="Offline plumbing check: synthetic data, gates reported but not enforced.")
    options = p.parse_args(argv)
    results_dir, max_rows, only, smoke = options.results_dir, options.max_rows, options.only, options.smoke

    if not smoke and settings.ALLOW_RANDOM_WEIGHTS:
        raise SystemExit("ALLOW_RANDOM_WEIGHTS is set — validation must run real checkpoints "
                         "(use --smoke for the offline plumbing check)")

    known_gates = {gate for _, _, gate, _ in STAGES}
    unknown = set(only) - known_gates
    if unknown:
        raise SystemExit(f"unknown gate(s) {sorted(unknown)}; valid: {sorted(known_gates)}")

    os.makedirs(results_dir, exist_ok=True)
    summary = {}
    failed = []
    for mod_name, result_file, gate, has_synthetic in STAGES:
        if only and gate not in only:
            continue
        if smoke and not has_synthetic:
            summary[gate] = {"status": "skipped", "reason": "no synthetic mode"}
            continue
        t0 = time.time()
        try:
            run_stage(mod_name, results_dir, max_rows, synthetic=smoke)
        except Exception as e:  # dataset, download or pipeline failure
            summary[gate] = {"status": "error", "error": f"{type(e).__name__}: {e}"}
            failed.append(gate)
            logger.error("%s benchmark failed: %s", gate, e)
            continue
        with open(os.path.join(results_dir, result_file)) as f:
            data = json.load(f)
        try:
            VERIFIERS[gate](data)
            status = "pass"
        except ValueError as e:
            status = "below threshold"
            if not smoke:
                failed.append(gate)
            logger.warning("%s gate: %s", gate, e)
        except Exception as e:  # the result file's structure: always fatal
            status = f"structure error: {e}"
            failed.append(gate)
        summary[gate] = {"status": status, "seconds": round(time.time() - t0, 1), "results": result_file}
        logger.info("%s: %s (%.1fs)", gate, status, time.time() - t0)

    with open(os.path.join(results_dir, "validation_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    if failed:
        raise SystemExit(f"gates failed: {', '.join(failed)}")
    print("all gates passed" if not smoke else "smoke run complete")


if __name__ == "__main__":
    main()
