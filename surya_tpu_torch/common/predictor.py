"""BasePredictor: the uniform task API of the port (counterpart of
surya_tpu/common/predictor.py, without the mesh code).

Construction loads the model on an explicit device; ``__call__`` maps
images to typed results. Batch-size defaults are keyed by the device type.
"""

from __future__ import annotations

from typing import Dict, Optional

from surya_tpu_torch.settings import resolve_device, settings


class BasePredictor:
    default_batch_sizes: Dict[str, int] = {"cpu": 2, "cuda": 32}
    batch_size: Optional[int] = None

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.disable_tqdm = settings.DISABLE_TQDM
        self._load()

    def _load(self):
        raise NotImplementedError

    def get_batch_size(self) -> int:
        if self.batch_size is not None:
            return self.batch_size
        return self.default_batch_sizes[self.device.type]

    def __call__(self, *args, **kwargs):
        raise NotImplementedError
