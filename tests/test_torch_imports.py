"""The port imports and runs with JAX unavailable, as on the GPU machine:
in a subprocess where ``import jax`` fails, the slice's modules import and
a tiny predictor recognizes a page on the CPU."""

import os
import subprocess
import sys
import textwrap

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError

    import torch
    torch.set_num_threads(1)
    from PIL import Image, ImageDraw

    import surya_tpu_torch.ops.decode_attn
    import surya_tpu_torch.ops.flash
    import surya_tpu_torch.models.foundation
    from surya_tpu_torch.recognition import RecognitionPredictor

    img = Image.new("RGB", (512, 256), "white")
    ImageDraw.Draw(img).text((10, 10), "Hello", fill="black", font_size=40)
    pred = RecognitionPredictor(tiny=True, device="cpu")
    [page] = pred([img], bboxes=[[[0, 0, 300, 60], [0, 100, 200, 140]]])
    assert len(page.text_lines) == 2
    assert pred.last_decoded_tokens > 0
    jax_like = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert jax_like == ["jax"], jax_like  # only the blocking sentinel
    heavy = [m for m in sys.modules if m.startswith(("surya_tpu.models", "surya_tpu.ops", "surya_tpu.recognition"))]
    assert not heavy, heavy
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
