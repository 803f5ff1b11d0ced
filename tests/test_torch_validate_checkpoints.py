"""The port's checkpoint-validation command and its six accuracy stages
(``surya_tpu_torch/scripts/validate_checkpoints.py``,
``surya_tpu_torch/benchmark``) against the JAX package's command and the
repo's ``benchmark/``, on the CPU at tiny width.

Both packages' stages run on tiny predictors with shared weights (the port's
built from the JAX predictors' pytrees; the detectors with the blob hook, the
table recognizers with synthetic tables) patched into the stage modules, and
on the same in-memory rows (``chip_smoke.stage_datasets``) patched in for
``load_hf_dataset``: the result files have the same keys and every metric is
within 1e-6, timings left out. Also: the JAX command's own three tests run
against the port, the ``--smoke`` summary of all gates against the JAX
command's, the status rules, the port's ``ratio`` and ``levenshtein``
against rapidfuzz, its metrics and scoring against ``benchmark/utils``, and
its synthetic pages pixel for pixel against the JAX stages'."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from hypothesis import given, settings as hsettings, strategies as st
from PIL import ImageChops
from rapidfuzz import fuzz
from rapidfuzz.distance import Levenshtein

import benchmark.detection as jax_detection
import benchmark.layout as jax_layout
import benchmark.ordering as jax_ordering
import benchmark.recognition as jax_recognition
import benchmark.table_recognition as jax_table_recognition
import benchmark.texify as jax_texify
import benchmark.utils.data as jax_data
import benchmark.utils.metrics as jax_metrics
import benchmark.utils.scoring as jax_scoring
import benchmark.utils.verify_benchmark_scores as jax_verify
import chip_smoke
import surya_tpu.scripts.validate_checkpoints as jax_validate
import surya_tpu_torch.benchmark.detection as detection
import surya_tpu_torch.benchmark.layout as layout
import surya_tpu_torch.benchmark.ordering as ordering
import surya_tpu_torch.benchmark.recognition as recognition
import surya_tpu_torch.benchmark.table_recognition as table_recognition
import surya_tpu_torch.benchmark.texify as texify
import surya_tpu_torch.scripts.validate_checkpoints as validate
from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.layout import LayoutPredictor as JaxLayoutPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.table_rec import TableRecPredictor as JaxTableRecPredictor
from surya_tpu.table_rec import install_synthetic_tables as jax_install_synthetic_tables
from surya_tpu_torch.benchmark.utils import data, format_table, metrics, scoring
from surya_tpu_torch.benchmark.utils import verify_benchmark_scores as verify
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import settings as port_settings
from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables

torch.set_num_threads(1)

ROWS = 2
TIMING_KEYS = {"time_per_image", "time_per_img", "total_time"}
# gate -> (the port's stage, the JAX stage, the predictor class it builds, its result file)
STAGES = {
    "detection": (detection, jax_detection, "DetectionPredictor", "det_bench.json"),
    "recognition": (recognition, jax_recognition, "RecognitionPredictor", "rec_bench.json"),
    "layout": (layout, jax_layout, "LayoutPredictor", "layout_bench.json"),
    "ordering": (ordering, jax_ordering, "LayoutPredictor", "order_bench.json"),
    "table_recognition": (table_recognition, jax_table_recognition, "TableRecPredictor", "table_rec_bench.json"),
    "texify": (texify, jax_texify, "RecognitionPredictor", "texify_bench.json"),
}
SYNTHETIC_GATES = [gate for _, _, gate, synthetic in validate.STAGES if synthetic]


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


def _tree(pred):
    return jax.tree.map(np.asarray, pred.params)


@pytest.fixture(scope="module")
def predictors():
    """class name -> (JAX predictor, the port's on its weights), tiny."""
    jdet = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    jax_evit.install_blob_detector(jdet)
    det = DetectionPredictor(None, True, device="cpu", jax_params=_tree(jdet))
    efficientvit.install_blob_detector(det)
    jrec = JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True)
    jlay = JaxLayoutPredictor(checkpoint=os.devnull, tiny=True)
    jtab = JaxTableRecPredictor(checkpoint=os.devnull, tiny=True)
    jax_install_synthetic_tables(jtab, n_rows=4, n_cols=3, n_cells=1)
    tab = TableRecPredictor(None, True, device="cpu", jax_params=_tree(jtab))
    install_synthetic_tables(tab, n_rows=4, n_cols=3, n_cells=1)
    return {
        "DetectionPredictor": (jdet, det),
        "RecognitionPredictor": (jrec, RecognitionPredictor(None, True, device="cpu", jax_params=_tree(jrec))),
        "LayoutPredictor": (jlay, LayoutPredictor(None, True, device="cpu", jax_params=_tree(jlay))),
        "TableRecPredictor": (jtab, tab),
    }


def _patch_stages(monkeypatch, predictors, gates=STAGES, jax_side=True):
    """The tiny predictors and in-memory rows in the stage modules, fresh
    rows for each package."""
    for gate in gates:
        module, jax_module, cls, _ = STAGES[gate]
        jax_pred, pred = predictors[cls]
        for mod, p in [(module, pred)] + ([(jax_module, jax_pred)] if jax_side else []):
            monkeypatch.setattr(mod, cls, lambda *a, _p=p, **k: _p)
            monkeypatch.setattr(mod, "load_hf_dataset",
                                chip_smoke.dataset_loader(gate, chip_smoke.stage_datasets(ROWS)[gate]))


def _run_jax_stage(jax_module, results_dir, synthetic):
    kwargs = {p.name: p.default for p in jax_module.main.params}
    kwargs.update(results_dir=str(results_dir), max_rows=ROWS, synthetic=synthetic)
    jax_module.main.callback(**kwargs)


def _same(got, ref, path="results"):
    """got has ref's keys; every number within 1e-6, timings left out."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), f"{path}: keys {sorted(got)} vs {sorted(ref)}"
        for k in ref:
            if k not in TIMING_KEYS:
                _same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (int, float)) and not isinstance(ref, bool):
        assert isinstance(got, (int, float)) and abs(got - ref) <= 1e-6, f"{path}: {got} vs {ref}"
    else:
        assert got == ref, f"{path}: {got!r} vs {ref!r}"


CASES = [(gate, False) for gate in STAGES] + [(gate, True) for gate in SYNTHETIC_GATES]


@pytest.mark.parametrize("gate, synthetic", CASES, ids=[f"{g}-{'synthetic' if s else 'dataset'}" for g, s in CASES])
def test_stage_matches_jax(gate, synthetic, predictors, tmp_path, monkeypatch):
    module, jax_module, _, result_file = STAGES[gate]
    _patch_stages(monkeypatch, predictors, [gate])
    _run_jax_stage(jax_module, tmp_path / "jax", synthetic)
    returned = module.run(results_dir=str(tmp_path / "torch"), max_rows=ROWS, synthetic=synthetic)
    ref = json.loads((tmp_path / "jax" / result_file).read_text())
    got = json.loads((tmp_path / "torch" / result_file).read_text())
    assert json.loads(json.dumps(returned)) == got
    _same(got, ref)
    if gate == "detection":
        assert len(got["page_metrics"]) == ROWS and got["metrics"]["surya"]["recall"] > 0  # the blob hook finds lines
    if gate == "table_recognition":
        assert got["surya"]["mean_row_iou"] != -1.0  # the synthetic tables' rows were matched
    if gate == "texify":
        assert got["n"] == ROWS


@pytest.mark.parametrize("gate", list(STAGES))
def test_stage_options_are_the_jax_stages(gate):
    module, jax_module, _, _ = STAGES[gate]
    defaults = vars(module.parser().parse_args([]))
    jax_defaults = {p.name: p.default for p in jax_module.main.params}
    assert set(defaults) == {"results_dir", "max_rows", "synthetic"}
    for name in defaults:
        assert defaults[name] == jax_defaults[name], name
    assert vars(module.parser().parse_args(["--max_rows", "3", "--synthetic", "--results_dir", "x"])) == {
        "results_dir": "x", "max_rows": 3, "synthetic": True}


def test_stage_main_parses_its_argv(predictors, tmp_path, monkeypatch):
    _patch_stages(monkeypatch, predictors, ["table_recognition"], jax_side=False)
    table_recognition.main(["--results_dir", str(tmp_path), "--max_rows", "1", "--synthetic"])
    out = json.loads((tmp_path / "table_rec_bench.json").read_text())
    assert set(out["surya"]) == {"mean_row_iou", "mean_col_iou", "time_per_image"}


# -- the JAX command's own tests (tests/test_validate_checkpoints.py), on the port


def test_smoke_detection_stage(predictors, tmp_path, monkeypatch):
    det = predictors["DetectionPredictor"][1]
    monkeypatch.setattr(detection, "DetectionPredictor", lambda *a, **k: det)
    validate.main(["--results_dir", str(tmp_path), "--max_rows", "2", "--only", "detection", "--smoke"])
    summary = json.loads((tmp_path / "validation_summary.json").read_text())
    assert list(summary) == ["detection"]
    # random weights can't pass the gate, but the gate must run (structure ok)
    assert summary["detection"]["status"] in ("pass", "below threshold")
    assert (tmp_path / "det_bench.json").exists()


def test_refuses_random_weights_outside_smoke(tmp_path):
    assert port_settings.ALLOW_RANDOM_WEIGHTS
    with pytest.raises(SystemExit) as exit_info:
        validate.main(["--results_dir", str(tmp_path)])
    assert "ALLOW_RANDOM_WEIGHTS" in str(exit_info.value.code)
    assert not (tmp_path / "validation_summary.json").exists()


def test_gate_functions_accept_reference_shapes():
    verify.VERIFIERS["detection"]({"metrics": {"surya": {"precision": 0.95, "recall": 0.95}}})
    verify.VERIFIERS["recognition"]({"surya": {"avg_score": 0.95}})
    verify.VERIFIERS["layout"]({"metrics": {"Text": {"precision": 0.7, "recall": 0.7}}})
    verify.VERIFIERS["ordering"]({"mean_accuracy": 0.8})
    verify.VERIFIERS["table_recognition"]({"surya": {"mean_row_iou": 0.8, "mean_col_iou": 0.8}})
    verify.VERIFIERS["texify"]({"scores": 0.1})
    with pytest.raises(ValueError):
        verify.VERIFIERS["detection"]({"metrics": {"surya": {"precision": 0.5, "recall": 0.95}}})


# -- the command: all gates, the status rules, the gates themselves


def test_smoke_over_all_gates_gives_the_jax_statuses(predictors, tmp_path, monkeypatch, capsys):
    _patch_stages(monkeypatch, predictors)
    result = CliRunner().invoke(jax_validate.main, ["--results_dir", str(tmp_path / "jax"), "--max_rows", "1",
                                                    "--smoke"], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    capsys.readouterr()
    validate.main(["--results_dir", str(tmp_path / "torch"), "--max_rows", "1", "--smoke"])
    assert capsys.readouterr().out.rstrip().endswith("smoke run complete")
    ref = json.loads((tmp_path / "jax" / "validation_summary.json").read_text())
    got = json.loads((tmp_path / "torch" / "validation_summary.json").read_text())
    assert list(got) == list(ref) == list(STAGES)
    assert {g: s["status"] for g, s in got.items()} == {g: s["status"] for g, s in ref.items()}
    assert [g for g, s in got.items() if s["status"] == "skipped"] == ["layout", "ordering", "texify"]
    for gate in SYNTHETIC_GATES:
        assert got[gate]["status"] in ("pass", "below threshold") and got[gate]["results"] == ref[gate]["results"]
        _same(json.loads((tmp_path / "torch" / got[gate]["results"]).read_text()),
              json.loads((tmp_path / "jax" / ref[gate]["results"]).read_text()))


def test_unknown_gate_is_refused(tmp_path):
    with pytest.raises(SystemExit) as exit_info:
        validate.main(["--results_dir", str(tmp_path), "--only", "detection", "--only", "spelling", "--smoke"])
    assert "unknown gate(s) ['spelling']" in str(exit_info.value.code)
    assert not (tmp_path / "validation_summary.json").exists()


def _stand_in_stage(monkeypatch, module, result_file, out):
    def run(results_dir, max_rows, synthetic):
        if isinstance(out, Exception):
            raise out
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, result_file), "w") as f:
            json.dump(out, f)
    monkeypatch.setattr(module, "run", run)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "gated"])
def test_status_rules(smoke, tmp_path, monkeypatch, capsys):
    """A missing key is a structure error and an exception an error, each
    failing the run; below threshold fails it only outside --smoke."""
    monkeypatch.setattr(port_settings, "ALLOW_RANDOM_WEIGHTS", smoke)
    _stand_in_stage(monkeypatch, detection, "det_bench.json", {"metrics": {"surya": {"precision": 0.99}}})
    _stand_in_stage(monkeypatch, recognition, "rec_bench.json", {"surya": {"avg_score": 0.5}})
    _stand_in_stage(monkeypatch, table_recognition, "table_rec_bench.json", RuntimeError("no table"))
    argv = ["--results_dir", str(tmp_path), "--only", "detection", "--only", "recognition", "--only",
            "table_recognition"] + (["--smoke"] if smoke else [])
    with pytest.raises(SystemExit) as exit_info:
        validate.main(argv)
    failed = ["detection", "table_recognition"] if smoke else ["detection", "recognition", "table_recognition"]
    assert exit_info.value.code == f"gates failed: {', '.join(failed)}"
    summary = json.loads((tmp_path / "validation_summary.json").read_text())
    assert summary["detection"]["status"] == "structure error: 'recall'"
    assert summary["recognition"]["status"] == "below threshold"
    assert summary["table_recognition"] == {"status": "error", "error": "RuntimeError: no table"}
    assert json.loads(capsys.readouterr().out) == summary


def test_gated_run_passes_when_every_gate_passes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port_settings, "ALLOW_RANDOM_WEIGHTS", False)
    _stand_in_stage(monkeypatch, ordering, "order_bench.json", {"mean_accuracy": 0.75, "time_per_image": 1.0})
    _stand_in_stage(monkeypatch, texify, "texify_bench.json", {"scores": 0.2, "total_time": 1.0, "n": 2})
    validate.main(["--results_dir", str(tmp_path), "--only", "ordering", "--only", "texify"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("all gates passed")
    assert {g: s["status"] for g, s in json.loads((tmp_path / "validation_summary.json").read_text()).items()} == {
        "ordering": "pass", "texify": "pass"}


def test_stage_table_and_run_stage_defaults(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(layout, "run", lambda **kwargs: seen.update(kwargs))
    validate.run_stage("surya_tpu_torch.benchmark.layout", str(tmp_path), None, synthetic=True)
    assert seen == {"results_dir": str(tmp_path), "max_rows": 100, "synthetic": True}
    validate.run_stage("surya_tpu_torch.benchmark.layout", str(tmp_path), 3, synthetic=False)
    assert seen["max_rows"] == 3 and seen["synthetic"] is False
    jax_stages = [(m.replace("benchmark.", "surya_tpu_torch.benchmark."), f, g, s) for m, f, g, s in jax_validate.STAGES]
    assert validate.STAGES == jax_stages


GATE_INPUTS = [
    {"metrics": {"surya": {"precision": 0.91, "recall": 0.95}}},
    {"metrics": {"surya": {"precision": 0.9, "recall": 0.95}}},
    {"surya": {"avg_score": 0.9}}, {"surya": {"avg_score": 0.9000001}},
    {"metrics": {"Text": {"precision": 0.61, "recall": 0.7}, "List": {"precision": 0.0, "recall": 0.0}}},
    {"metrics": {"Title": {"precision": 0.6, "recall": 0.7}}},
    {"mean_accuracy": 0.75}, {"mean_accuracy": 0.7499},
    {"surya": {"mean_row_iou": 0.75, "mean_col_iou": 0.75}}, {"surya": {"mean_row_iou": 0.8, "mean_col_iou": 0.7}},
    {"scores": 0.2}, {"scores": 0.2001}, {},
]


def _gate_outcome(fn, data_):
    try:
        fn(data_)
        return "pass"
    except Exception as e:  # noqa: BLE001 - the kind of failure is the outcome
        return type(e).__name__


@pytest.mark.parametrize("gate", list(jax_verify.VERIFIERS))
def test_gates_equal_the_jax_gates(gate):
    assert list(verify.VERIFIERS) == list(jax_verify.VERIFIERS)
    outcomes = [_gate_outcome(verify.VERIFIERS[gate], d) for d in GATE_INPUTS]
    assert outcomes == [_gate_outcome(jax_verify.VERIFIERS[gate], d) for d in GATE_INPUTS]
    assert "pass" in outcomes and "ValueError" in outcomes


def test_verify_main(tmp_path, capsys):
    path = tmp_path / "rec_bench.json"
    path.write_text(json.dumps({"surya": {"avg_score": 0.95}}))
    verify.main([str(path), "--bench_type", "recognition"])
    assert capsys.readouterr().out.strip() == "recognition scores pass"
    with pytest.raises(ValueError, match="Invalid benchmark type"):
        verify.main([str(path), "--bench_type", "spelling"])
    det_path = tmp_path / "det_bench.json"
    det_path.write_text(json.dumps({"metrics": {"surya": {"precision": 0.95, "recall": 0.5}}}))
    with pytest.raises(ValueError, match="Detection scores"):
        verify.main([str(det_path)])  # the detection gate by default


# -- scoring against rapidfuzz, metrics against benchmark/utils

TEXT = st.text(alphabet=st.sampled_from("ab cé中"), max_size=40)


@hsettings(max_examples=300, deadline=None)
@given(TEXT, TEXT, st.sampled_from([0, 20, 50, 99]))
def test_ratio_equals_rapidfuzz(a, b, cutoff):
    assert abs(scoring.ratio(a, b, score_cutoff=cutoff) - fuzz.ratio(a, b, score_cutoff=cutoff)) <= 1e-9
    assert abs(scoring.ratio(a, b) - fuzz.ratio(a, b)) <= 1e-9


@hsettings(max_examples=300, deadline=None)
@given(TEXT, TEXT)
def test_levenshtein_equals_rapidfuzz(a, b):
    assert scoring.levenshtein(a, b) == Levenshtein.distance(a, b)


@pytest.mark.parametrize("a, b", [("", ""), ("", "abc"), ("abc", ""), ("aaaaa", "abbbb"), ("ab", "cd"),
                                  ("x" * 200 + "abc", "abd" + "y" * 150), ("kitten", "sitting")],
                         ids=["both-empty", "first-empty", "second-empty", "at-the-cutoff", "disjoint", "long",
                              "kitten"])
def test_scoring_edges_equal_rapidfuzz(a, b):
    # "aaaaa" / "abbbb": a similarity of exactly 1 - 0.8, which rounds below the cutoff of 20 in both
    for cutoff in (0, 20):
        assert scoring.ratio(a, b, score_cutoff=cutoff) == fuzz.ratio(a, b, score_cutoff=cutoff)
    assert scoring.levenshtein(a, b) == Levenshtein.distance(a, b)
    assert texify.normalized_edit_distance(a, b) == jax_texify.normalized_edit_distance(a, b)


def _random_boxes(rng, n, size=200):
    xy = rng.integers(0, size, (n, 2))
    wh = rng.integers(0, 60, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).tolist()


@pytest.mark.parametrize("seed", range(6))
def test_metrics_equal_benchmark_utils(seed):
    rng = np.random.default_rng(seed)
    preds, refs = _random_boxes(rng, int(rng.integers(0, 12))), _random_boxes(rng, int(rng.integers(0, 12)))
    for penalize in (True, False):
        assert metrics.precision_recall(preds, refs, penalize_double=penalize) == \
            jax_metrics.precision_recall(preds, refs, penalize_double=penalize)
    if preds or refs:
        assert metrics.penalized_iou_score(preds, refs) == jax_metrics.penalized_iou_score(preds, refs)
    assert metrics.match_boxes(preds, refs) == jax_metrics.match_boxes(preds, refs)
    assert metrics.mean_coverage(preds, refs) == jax_metrics.mean_coverage(preds, refs)
    for box in refs[:3]:
        assert metrics.calculate_iou(box, preds[0] if preds else box) == \
            jax_metrics.calculate_iou(box, preds[0] if preds else box)
    order_a, order_b = rng.permutation(8).tolist(), rng.permutation(8).tolist()
    assert metrics.rank_accuracy(order_a, order_b) == jax_metrics.rank_accuracy(order_a, order_b)


@pytest.mark.parametrize("seed", range(4))
def test_overlap_scores_equal_benchmark_utils(seed):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "x", ""]
    lines = [" ".join(rng.choice(words, int(rng.integers(0, 5)))) for _ in range(10)]
    preds, refs = lines[:5], lines[5:]
    assert scoring.overlap_score(preds, refs) == jax_scoring.overlap_score(preds, refs)
    assert scoring.overlap_score_exact(preds, refs) == jax_scoring.overlap_score_exact(preds, refs)
    refs_texts = [" ".join(lines[:3]), "", lines[4]]
    for pred, ref in zip(lines[5:8], refs_texts):
        assert texify.normalized_edit_distance(pred, ref) == jax_texify.normalized_edit_distance(pred, ref)


@pytest.mark.parametrize("kind, args", [("text", (2,)), ("text", (2, 3, (800, 260))), ("table", (2,))])
def test_synthetic_pages_equal_the_jax_stages(kind, args):
    fn = {"text": (data.synthetic_text_pages, jax_data.synthetic_text_pages),
          "table": (data.synthetic_table_pages, jax_data.synthetic_table_pages)}[kind]
    (images, *truth), (jax_images, *jax_truth) = fn[0](*args), fn[1](*args)
    assert truth == jax_truth and len(images) == len(jax_images) == args[0]
    for a, b in zip(images, jax_images):
        assert a.size == b.size and a.mode == b.mode and ImageChops.difference(a, b).getbbox() is None


def test_format_table():
    text = format_table([["surya", 0.5, 1], ["tesseract", 0.25, 10]], ["model", "score", "n"])
    assert text.splitlines() == ["model      score   n", "---------  -----  --",
                                 "surya        0.5   1", "tesseract   0.25  10"]
