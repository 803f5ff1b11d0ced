"""BasePredictor: the uniform task API of the port (counterpart of
surya_tpu/common/predictor.py, without the mesh code).

Construction loads the model on an explicit device; ``__call__`` maps
images (or texts) to typed results. Every predictor takes the JAX
package's positional arguments ``(checkpoint=None, tiny=False)``; loading
a checkpoint is not ported, so a checkpoint that is given raises.
Batch-size defaults are keyed by the device type; a settings field, read
when the batch size is asked for, overrides them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from surya_tpu_torch.settings import resolve_device, settings


class BasePredictor:
    default_batch_sizes: Dict[str, int] = {"cpu": 2, "cuda": 32}
    batch_size_setting: Optional[str] = None  # name of the settings field that overrides the default

    def __init__(self, checkpoint: Optional[str] = None, device=None):
        if checkpoint is not None:
            raise NotImplementedError(
                f"checkpoint {checkpoint!r}: the PyTorch port cannot load checkpoints yet; pass "
                "checkpoint=None for random weights (ALLOW_RANDOM_WEIGHTS=true) or jax_params= for a JAX pytree"
            )
        self.device = resolve_device(device)
        self.disable_tqdm = settings.DISABLE_TQDM
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._load()

    def _load(self):
        raise NotImplementedError

    # -- host <-> device ---------------------------------------------------------
    # On CUDA each predictor runs on a stream of its own: its uploads leave
    # pinned host memory without blocking the host, and the host waits for a
    # fetched output on an event, so it waits for that predictor's work only
    # and not for another predictor's on the same card.

    def _on_stream(self):
        """The predictor's stream as the current one (nothing on the CPU).
        Wrap no `yield` in it: the stream would stay current for the caller."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def _host_buffer(self, shape, dtype=torch.uint8) -> torch.Tensor:
        """A host tensor the device copies from without blocking: pinned on CUDA."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _upload(self, host) -> torch.Tensor:
        """A numpy array or host tensor -> the device, on the current stream;
        the host does not wait (the array goes through pinned memory)."""
        if isinstance(host, np.ndarray):
            host = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type == "cpu":
            return host
        if not host.is_pinned():
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _fetch(self, *tensors: torch.Tensor):
        """Enqueue device -> host copies of tensors on the current stream;
        returns a handle for ``_wait``."""
        if self.device.type == "cpu":
            return tensors, None
        hosts = []
        for t in tensors:
            hosts.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            hosts[-1].copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return hosts, event

    @staticmethod
    def _wait(handle) -> List[np.ndarray]:
        """The fetched arrays, once their copies have landed (an event wait)."""
        hosts, event = handle
        if event is not None:
            event.synchronize()
        return [h.numpy() for h in hosts]

    def get_batch_size(self) -> int:
        size = getattr(settings, self.batch_size_setting) if self.batch_size_setting else None
        return size if size is not None else self.default_batch_sizes[self.device.type]

    def pipeline_cap(self, setting_value: Optional[int], batch_size: int) -> int:
        """Rows per dispatch for a pipelined predictor: the configured cap,
        else 8 on CUDA (two or more dispatches for a typical call, so the
        host's prepare and upload of one overlap the device's work on the
        other), else the whole batch."""
        cap = setting_value
        if cap is None:
            cap = 8 if self.device.type == "cuda" else batch_size
        return min(batch_size, max(1, cap))

    @staticmethod
    def is_gray(pixels: np.ndarray) -> bool:
        """Whether every pixel of [..., H, W, 3] has R == G == B. A strided
        sample gates the full compare, so colour images pay almost nothing."""
        s = pixels[..., ::16, ::16, :]
        if not ((s[..., 0] == s[..., 1]).all() and (s[..., 1] == s[..., 2]).all()):
            return False
        return bool((pixels[..., 0] == pixels[..., 1]).all() and (pixels[..., 1] == pixels[..., 2]).all())

    @staticmethod
    def gray_ship(pixels: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] uint8 -> [B, H, W, 1] when every pixel has R == G == B
        (most documents): a third of the bytes to the device, whose program
        broadcasts the channel back, bit for bit."""
        if pixels.ndim != 4 or pixels.shape[-1] != 3 or not BasePredictor.is_gray(pixels):
            return pixels
        return np.ascontiguousarray(pixels[..., :1])

    def __call__(self, *args, **kwargs):
        raise NotImplementedError
