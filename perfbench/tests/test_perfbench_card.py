"""Each cell of BENCHMARK.json, a short run on the card (skips without
one): ``python -m pytest perfbench/tests -m gpu`` on a machine with an H100."""

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny

CELLS = [w["name"] for w in json.loads((tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 97),
                           "--seconds", "3", "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["kind"] == card
