"""The per-layer metrics that read the program's own spans and counters of
OCR's scheduler and assembly and of layout's entry: a traced run of each
tiny cell on the CPU reads every one of them."""

import pytest

from perfbench.tests import tiny

SEED = 2**31 + 41
METRICS = {
    "ocr": ("assemble_s_per_page.ocr", "loop_host_s_per_page.ocr", "prefill_patch_use.ocr", "decode_row_use.ocr"),
    "layout": ("prepare_s_per_page.layout", "wait_s_per_page.layout", "assemble_s_per_page.layout"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("perfbench_spans"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_traced_run_reads_the_program_spans(root, cell):
    out = tiny.run_cell(root, cell, SEED, trace=1)
    assert out["correct"], out["checks"]
    names = METRICS["layout" if "layout" in cell else "ocr"]
    for name in names:
        assert name in out["metrics"], (name, sorted(out["metrics"]))
        value = out["metrics"][name]["value"]
        if name.endswith("_use.ocr"):
            assert 0 < value <= 100, (name, value)
        else:
            assert value >= 0, (name, value)
