"""BasePredictor: the uniform task API of the port (counterpart of
surya_tpu/common/predictor.py).

Construction loads the model on an explicit device; ``__call__`` maps
images (or texts) to typed results. Every predictor takes the JAX
package's positional arguments ``(checkpoint=None, tiny=False)``: the
checkpoint (a local directory or an ``s3://`` name, default the model's
``*_MODEL_CHECKPOINT`` setting) goes to the model's loader.
Batch-size defaults are keyed by the device type; a settings field, read
when the batch size is asked for, overrides them.

The mesh (parallel/mesh.py): a predictor takes ``mesh=`` beside ``device=``
(its device is then the mesh's first, where outputs gather), and with
USE_MESH on and more than one card it builds one (``setup_mesh``). The batch
predictors split their rows over the data axis (``data_parallel``: a block
of rows a data shard, each through the model's replica on its device);
recognition also splits its decoder over the model axis.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from surya_tpu_torch.parallel.mesh import Mesh, gather_rows, make_mesh, replicate
from surya_tpu_torch.settings import resolve_device, settings


def row_bucket(current: int, batch_size: int) -> int:
    """Rows a batch of `current` items runs at: the next power of two, at
    most the batch size."""
    return min(1 << max(current - 1, 0).bit_length(), batch_size)


class BasePredictor:
    default_batch_sizes: Dict[str, int] = {"cpu": 2, "cuda": 32}
    batch_size_setting: Optional[str] = None  # name of the settings field that overrides the default
    mesh: Optional[Mesh] = None  # set by setup_mesh

    def __init__(self, checkpoint: Optional[str] = None, device=None, mesh: Optional[Mesh] = None):
        self.checkpoint = checkpoint
        if mesh is not None and device is not None and torch.device(device) != mesh.first:
            raise ValueError(f"device {device} is not the mesh's first device {mesh.first}")
        self.device = resolve_device(device if mesh is None else mesh.first)
        self.disable_tqdm = settings.DISABLE_TQDM
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._mesh_arg = mesh
        self._mesh_streams: List[torch.cuda.Stream] = []
        self._replicas: dict = {}
        self._load()

    def _load(self):
        raise NotImplementedError

    # -- the mesh -----------------------------------------------------------------

    def setup_mesh(self, tensor_parallel: bool = False) -> None:
        """The predictor's mesh: the one it was given, else, with USE_MESH on
        and more than one card, every card (make_mesh: a data mesh, or with
        tensor_parallel MESH_NUM_MODEL_SHARDS model shards); none otherwise.
        Call at the end of _load. A stream is made on each other CUDA device
        of the mesh."""
        mesh = self._mesh_arg
        if mesh is None and settings.USE_MESH and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            mesh = make_mesh(n_model=None if tensor_parallel else 1)
        if mesh is not None and not tensor_parallel and mesh.n_model != 1:
            raise ValueError(f"{type(self).__name__} splits its batch over a data mesh (one model shard), got {mesh}")
        self.mesh = mesh
        self._mesh_streams = [torch.cuda.Stream(dev) for dev in (mesh.distinct() if mesh else ())
                              if dev.type == "cuda" and dev != self.device]

    def replica(self, device) -> torch.nn.Module:
        """The model on `device`: the predictor's own there, else a copy made
        at first use (parallel/mesh.replicate) and kept. A copy does not see
        later edits of self.model: edit the weights before the first meshed
        call, or edit every model of models()."""
        device = torch.device(device)
        if device == self.device:
            return self.model
        if device not in self._replicas:
            self._replicas[device] = replicate(self.model, device)
        return self._replicas[device]

    def models(self) -> List[torch.nn.Module]:
        """The model and the replicas made so far (a hook that edits the
        model edits them all; replicas made later copy the edited model)."""
        return [self.model, *self._replicas.values()]

    def shard_pixels(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A batch on the predictor's device, its rows split over the mesh's
        data axis, each block on its shard's device ([x] without a mesh);
        round_batch keeps the blocks even."""
        if self.mesh is None:
            return [x]
        return [part.to(self.mesh.device(d, 0)) for d, part in enumerate(x.tensor_split(self.mesh.n_data))]

    def data_parallel(self, fn, *xs: torch.Tensor) -> torch.Tensor:
        """fn(model, *row blocks) once a data shard, on the blocks of xs
        (each a batch on the predictor's device) with the model on the
        shard's device, the outputs joined on the predictor's device:
        fn(self.model, *xs) without a mesh."""
        if self.mesh is None:
            return fn(self.model, *xs)
        blocks = [self.shard_pixels(x) for x in xs]
        outs = [fn(self.replica(self.mesh.device(d, 0)), *(b[d] for b in blocks)) for d in range(self.mesh.n_data)]
        return gather_rows(outs, self.device)

    def round_batch(self, n: int) -> int:
        """n rounded up to a multiple of the data axis (n without a mesh)."""
        if self.mesh is None:
            return n
        d = self.mesh.n_data
        return -(-n // d) * d

    def bucket_rows(self, current: int, batch_size: int) -> int:
        """Rows for a batch of `current` items: the next power of two, at
        most batch_size, at least current, rounded up to the data axis after
        the max (the JAX package rounds before it, so a batch above
        batch_size can come out unaligned)."""
        return self.round_batch(max(row_bucket(current, batch_size), current))

    # -- host <-> device ---------------------------------------------------------
    # On CUDA each predictor runs on a stream of its own: its uploads leave
    # pinned host memory without blocking the host, and the host waits for a
    # fetched output on an event, so it waits for that predictor's work only
    # and not for another predictor's on the same card.

    def _on_stream(self):
        """The predictor's stream as the current one (nothing on the CPU),
        and its stream on each other device of its mesh; the predictor's
        device stays the current one. Wrap no `yield` in it: the streams
        would stay current for the caller."""
        if self._stream is None:
            return contextlib.nullcontext()
        if not self._mesh_streams:
            return torch.cuda.stream(self._stream)
        stack = contextlib.ExitStack()
        for stream in (*self._mesh_streams, self._stream):
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _host_buffer(self, shape, dtype=torch.uint8) -> torch.Tensor:
        """A host tensor the device copies from without blocking: pinned on CUDA."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _pinned(self, host: np.ndarray) -> torch.Tensor:
        """A numpy array as a host tensor that a copy to the device reads
        without the host waiting (pinned on CUDA): a program's input, which
        the program's store copies straight into its static input."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _upload(self, host, device=None) -> torch.Tensor:
        """A numpy array or host tensor -> the device (default the
        predictor's), on the current stream; the host does not wait (the
        array goes through pinned memory)."""
        if isinstance(host, np.ndarray):
            host = torch.from_numpy(np.ascontiguousarray(host))
        device = self.device if device is None else device
        if device.type == "cpu":
            return host
        if not host.is_pinned():
            host = host.pin_memory()
        return host.to(device, non_blocking=True)

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
