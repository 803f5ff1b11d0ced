"""The port imports and runs with JAX and the JAX package unavailable, as on
the GPU machine: in a subprocess where ``import jax`` and ``import
surya_tpu`` fail, the port's modules import, tiny predictors recognize given
lines and run a whole-page OCR (detection, then recognition with the int8
KV cache) on the CPU, and no module of either is loaded afterwards."""

import os
import subprocess
import sys
import textwrap

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.modules["surya_tpu"] = None  # and so does any import of the JAX package

    import torch
    torch.set_num_threads(1)
    from PIL import Image, ImageDraw

    import surya_tpu_torch.ops.decode_attn
    import surya_tpu_torch.ops.flash
    import surya_tpu_torch.models.foundation
    from surya_tpu_torch.detection import DetectionPredictor
    from surya_tpu_torch.models.efficientvit import install_blob_detector
    from surya_tpu_torch.recognition import RecognitionPredictor
    from surya_tpu_torch.settings import settings

    img = Image.new("RGB", (512, 256), "white")
    ImageDraw.Draw(img).text((10, 10), "Hello", fill="black", font_size=40)
    pred = RecognitionPredictor(tiny=True, device="cpu")
    [page] = pred([img], bboxes=[[[0, 0, 300, 60], [0, 100, 200, 140]]])
    assert len(page.text_lines) == 2
    assert pred.last_decoded_tokens > 0

    det = DetectionPredictor(tiny=True, device="cpu")
    install_blob_detector(det)
    settings.RECOGNITION_MODEL_QUANTIZE = True
    [page] = pred([img], det_predictor=det)
    assert len(page.text_lines) == 1 and pred.last_decoded_tokens > 0

    jax_like = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert jax_like == ["jax"], jax_like  # only the blocking sentinel
    jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "surya_tpu")
    assert jax_package == ["surya_tpu"], jax_package  # only the blocking sentinel
    print("OK")
    """
)


def test_port_runs_without_jax():
    env = dict(os.environ, ALLOW_RANDOM_WEIGHTS="true", RECOGNITION_MAX_TOKENS="8", DISABLE_TQDM="true")
    env.pop("TORCH_DEVICE", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=root, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
