"""The port's entry points run on the card unless the caller asks for the CPU.

With no device given and no CUDA present (as on a CPU-only machine; CUDA is
hidden here where a card exists), building a predictor raises instead of
running quietly on the CPU; ``device="cpu"`` and ``TORCH_DEVICE=cpu`` work.

Every predictor takes the JAX package's positional arguments
``(checkpoint=None, tiny=False)``: a checkpoint directory is loaded, a
checkpoint that resolves to nothing raises FileNotFoundError unless
ALLOW_RANDOM_WEIGHTS, so code written against the JAX API never gets a
random model in silence, and ``Predictor(None, True, device="cpu")`` builds
the tiny model."""

import os
import re

import pytest
import torch

import chip_smoke
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


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    from surya_tpu_torch.settings import settings as port_settings

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


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
def test_a_checkpoint_raises(no_cuda, monkeypatch, tmp_path, kind):
    """A checkpoint that resolves to nothing raises under
    ALLOW_RANDOM_WEIGHTS=false, with the JAX loaders' message."""
    monkeypatch.setattr(settings, "ALLOW_RANDOM_WEIGHTS", False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PREDICTORS[kind](str(tmp_path / "missing"))  # the device is checked first
    with pytest.raises(FileNotFoundError, match=re.escape(f"checkpoint '{tmp_path / 'missing'}' not found locally")):
        PREDICTORS[kind](str(tmp_path / "missing"), True, device="cpu")
    with pytest.raises(FileNotFoundError, match="not found locally and not downloadable"):
        PREDICTORS[kind](None, True, device="cpu")  # the default setting, here a path that does not exist


@pytest.mark.parametrize("kind", sorted(PREDICTORS))
def test_positional_arguments_are_the_jax_packages(no_cuda, kind):
    pred = PREDICTORS[kind](None, True, device="cpu")
    tiny = PREDICTORS[kind](tiny=True, device="cpu")
    assert pred.device == torch.device("cpu") and pred.config == tiny.config
    with pytest.raises(TypeError):
        PREDICTORS[kind](None, True, "cpu")  # the device is keyword-only


def test_registry_builds_the_five_predictors(no_cuda, tmp_path):
    preds = load_predictors(device="cpu", tiny=True)
    assert {k: type(v) for k, v in preds.items()} == {k: PREDICTORS[k] for k in PREDICTORS}
    # an entry of `checkpoints` goes to its predictor: a checkpoint directory
    # (written as upstream ships one) is loaded, the others are random
    chip_smoke.write_checkpoint(tmp_path, "layout", preds["layout"].model, preds["layout"].config,
                                torch.Generator().manual_seed(0))
    preds = load_predictors({"layout": str(tmp_path)}, device="cpu", tiny=True)
    assert preds["layout"].checkpoint == str(tmp_path) and preds["recognition"].checkpoint is None
    assert (tmp_path / ".torch_cache_layout_float32_v1.safetensors").exists()
