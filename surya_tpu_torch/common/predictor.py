"""BasePredictor: the uniform task API of the port (counterpart of
surya_tpu/common/predictor.py, without the mesh code).

Construction loads the model on an explicit device; ``__call__`` maps
images to typed results. Batch-size defaults are keyed by the device type;
a settings field, read when the batch size is asked for, overrides them.
"""

from __future__ import annotations

from typing import Dict, Optional

from surya_tpu_torch.settings import resolve_device, settings


class BasePredictor:
    default_batch_sizes: Dict[str, int] = {"cpu": 2, "cuda": 32}
    batch_size_setting: Optional[str] = None  # name of the settings field that overrides the default

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.disable_tqdm = settings.DISABLE_TQDM
        self._load()

    def _load(self):
        raise NotImplementedError

    def get_batch_size(self) -> int:
        size = getattr(settings, self.batch_size_setting) if self.batch_size_setting else None
        return size if size is not None else self.default_batch_sizes[self.device.type]

    def __call__(self, *args, **kwargs):
        raise NotImplementedError
