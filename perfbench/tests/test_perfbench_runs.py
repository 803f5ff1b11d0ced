"""Whole runs of the harness on the CPU, at the program's tiny widths, in a
throwaway checkout: every step but the look for a card. Sound runs come
out correct; the control and each fault that a served cell can have come
out not correct; files added to the checkout are picked up by name."""

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny

SEED = 2**31 + 29
# a fault planted in the program before the run (Python run first in its process)
FAULTS = {
    # a token altered where it is produced: the greedy pick moved one id on
    "token": ("tiny.ocr.lines", "bad_tokens",
              "from surya_tpu_torch.models.foundation import FoundationModel as M\n"
              "_f = M.sample_greedy\n"
              "def _g(self, h):\n"
              "    t, s, b = _f(self, h)\n"
              "    return (t + 1) % self.config.vocab_size, s, b\n"
              "M.sample_greedy = _g\n"),
    # an answer altered where it is produced: every box moved 5 % of the page
    "box": ("tiny.layout", "box_diff",
            "from surya_tpu_torch.models.layout_model import LayoutModel as M\n"
            "_f = M.heads\n"
            "def _g(self, h):\n"
            "    c, b = _f(self, h)\n"
            "    return c, (b + 0.05).clamp(max=1.0)\n"
            "M.heads = _g\n"),
    # detection's answer altered: every line box half a line lower
    "detection": ("tiny.ocr.pages", "det_line_errors",
                  "from surya_tpu_torch.detection import DetectionPredictor as D\n"
                  "_f = D.__call__\n"
                  "def _g(self, *a, **k):\n"
                  "    out = _f(self, *a, **k)\n"
                  "    for r in out:\n"
                  "        for b in r.bboxes:\n"
                  "            b.polygon = [[x, y + 21] for x, y in b.polygon]\n"
                  "    return out\n"
                  "D.__call__ = _g\n"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("perfbench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(root, cell):
    out = tiny.run_cell(root, cell, SEED)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-2:] == ["checks", "stderr"]  # the numbers compared come last
    assert out["metrics"]["setup_s"]["value"] > 0
    for name, c in out["checks"].items():
        assert f"check {name}: " in out["stderr"]


@pytest.mark.parametrize("cell", ["tiny.ocr.lines", "tiny.layout"])
def test_control_is_not_correct(root, cell):
    out = tiny.run_cell(root, cell, SEED, control=1)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(root, fault):
    cell, number, setup = FAULTS[fault]
    out = tiny.run_cell(root, cell, SEED, setup=setup)
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_added_metric_and_traffic_are_found(root):
    """A later change adds a mix and a reader as files and entries only."""
    mixes = root / "perfbench" / "traffic"
    mix = json.loads((mixes / "tiny_lines.json").read_text())
    (mixes / "tiny_lines_long.json").write_text(json.dumps(dict(mix, decode_tokens=14)))
    (root / "perfbench" / "metrics" / "pages_after_trace.ocr.py").write_text(
        "def read(run):\n    return float(run.stage_pages) if run.stage_pages else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.ocr.lines_long", "config": "tiny_ocr", "traffic": "tiny_lines_long",
                               "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "pages_after_trace.ocr", "unit": "pages", "better": "higher",
                               "source": "program_counter", "layer": "scheduler", "moves": "ocr_pages_per_s",
                               "workloads": ["tiny.ocr.lines_long"]})
    bench["end_to_end"][0]["workloads"].append("tiny.ocr.lines_long")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = root / "perfbench" / "limits"
    (limits / "tiny.ocr.lines_long.json").write_text((limits / "tiny.ocr.lines.json").read_text())
    out = tiny.run_cell(root, "tiny.ocr.lines_long", SEED, trace=1)
    assert out["correct"], out["checks"]
    assert out["metrics"]["pages_after_trace.ocr"]["value"] > 0
    # device metrics have nothing to read on the CPU, and are left out
    assert "idle_share.ocr" not in out["metrics"] and "mfu.ocr" not in out["metrics"]


def test_no_card_no_result():
    """Without a CUDA card the command exits with an error and prints no result."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "ocr.lines40", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_reference_and_counts_load_nothing_of_the_program():
    code = ("import sys\n"
            "import perfbench.reference.foundation, perfbench.reference.layout, perfbench.reference.precision\n"
            "import perfbench.counts.ocr, perfbench.counts.layout, perfbench.traffic, perfbench.weights\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'surya_tpu', "
            "'surya_tpu_torch'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_a_run_loads_no_jax(root):
    code = ("import sys, runpy\n"
            f"sys.path.insert(0, {str(root)!r})\n"
            "from perfbench import harness\n"
            "harness.run(['--workload', 'tiny.ocr.lines', '--seed', '5', '--seconds', '1'], device='cpu', tiny=True)\n"
            "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=600,
                          env={**tiny.os.environ, "TORCH_DEVICE": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
