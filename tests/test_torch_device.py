"""The port's entry points run on the card unless the caller asks for the CPU.

With no device given and no CUDA present (as on a CPU-only machine; CUDA is
hidden here where a card exists), building a predictor raises instead of
running quietly on the CPU; ``device="cpu"`` and ``TORCH_DEVICE=cpu`` work.

Every predictor takes the JAX package's positional arguments
``(checkpoint=None, tiny=False)``: a checkpoint raises (loading one is not
ported), so code written against the JAX API never gets a random model in
silence, and ``Predictor(None, True, device="cpu")`` builds the tiny model."""

import pytest
import torch

from surya_tpu_torch import settings as settings_module
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.models_registry import load_predictors
from surya_tpu_torch.ocr_error import OCRErrorPredictor
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import Settings, resolve_device, settings
from surya_tpu_torch.table_rec import TableRecPredictor

PREDICTORS = {"recognition": RecognitionPredictor, "detection": DetectionPredictor, "layout": LayoutPredictor,
              "table_rec": TableRecPredictor, "ocr_error": OCRErrorPredictor}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "TORCH_DEVICE", None)
    monkeypatch.setattr(settings, "ALLOW_RANDOM_WEIGHTS", True)


@pytest.mark.parametrize("kind", sorted(PREDICTORS))
def test_predictor_without_a_device_raises_without_cuda(no_cuda, kind):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PREDICTORS[kind](tiny=True)


@pytest.mark.parametrize("kind", sorted(PREDICTORS))
def test_predictor_runs_on_the_cpu_when_asked(no_cuda, kind):
    pred = PREDICTORS[kind](tiny=True, device="cpu")
    assert pred.device == torch.device("cpu")
    assert next(pred.model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("kind", sorted(PREDICTORS))
def test_torch_device_cpu_is_read(no_cuda, monkeypatch, kind):
    monkeypatch.setattr(settings, "TORCH_DEVICE", Settings({"TORCH_DEVICE": "cpu"}).TORCH_DEVICE)
    assert PREDICTORS[kind](tiny=True).device == torch.device("cpu")


@pytest.mark.parametrize("device", [None, "cuda", "cuda:1"])
def test_resolve_device_never_falls_back_to_the_cpu(no_cuda, device):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(device)
    assert settings_module.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kind", sorted(PREDICTORS))
def test_a_checkpoint_raises(no_cuda, kind):
    with pytest.raises(NotImplementedError, match="cannot load checkpoints"):
        PREDICTORS[kind]("s3://x")
    with pytest.raises(NotImplementedError, match="cannot load checkpoints"):
        PREDICTORS[kind]("s3://x", True, device="cpu")


@pytest.mark.parametrize("kind", sorted(PREDICTORS))
def test_positional_arguments_are_the_jax_packages(no_cuda, kind):
    pred = PREDICTORS[kind](None, True, device="cpu")
    tiny = PREDICTORS[kind](tiny=True, device="cpu")
    assert pred.device == torch.device("cpu") and pred.config == tiny.config
    with pytest.raises(TypeError):
        PREDICTORS[kind](None, True, "cpu")  # the device is keyword-only


def test_registry_builds_the_five_predictors(no_cuda):
    preds = load_predictors(device="cpu", tiny=True)
    assert {k: type(v) for k, v in preds.items()} == {k: PREDICTORS[k] for k in PREDICTORS}
    with pytest.raises(NotImplementedError):
        load_predictors({"layout": "s3://layout/2025_02_18"}, device="cpu", tiny=True)
