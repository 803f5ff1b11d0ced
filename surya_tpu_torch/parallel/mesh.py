"""The multi-device mesh of the port: counterpart of surya_tpu/parallel/mesh.py.

A ``Mesh`` is a (data, model) grid of ``torch.device``s in one process, as a
JAX ``Mesh`` is a grid of devices, and a device may repeat: a 2x2 mesh of
``cuda:0`` runs every sharded code path on one card, and the same code
spreads over ``cuda:0..3`` where there are four. Position (d, m) of the grid
is a shard. A shard owns its block of every sharded array as a tensor of its
own (``Sharded``), as a JAX sharded array is per-device buffers, and it does
the work its device does in the JAX package's SPMD program, replicated work
included; on a mesh whose devices repeat, shards on one device run one after
the other on its stream.

What is sharded: batch axes (recognition's slots and prefill rows, the batch
predictors' rows) over ``data``; recognition's decoder over ``model``, by the
plan of the JAX package's ``_decoder_tp_spec`` (the reference's unused HF TP
hints): q/k/v/gate/up column slices, o/down row slices. Where XLA inserts
collectives, the port calls plain functions: ``all_reduce_sum`` (the
row-parallel sum) and ``Sharded.gather`` (to one device, for the host).

A mesh axis that does not divide a dimension splits it unevenly, as
``torch.tensor_split`` does (GSPMD pads instead); the kernel dispatchers then
run the single-device kernel on the inputs gathered to the mesh's first
device (``kernel_shardable``).
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch.nn import QuantLinear
from surya_tpu_torch.settings import settings

DATA_AXIS = "data"  # the axes' names in a Sharded spec (the JAX package's defaults)
MODEL_AXIS = "model"

Coord = Tuple[int, int]


class Mesh:
    """A (data, model) grid of devices; ``devices[d][m]`` runs shard (d, m)."""

    def __init__(self, devices: Sequence[Sequence]):
        grid = tuple(tuple(torch.device(x) for x in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError(f"a mesh needs a non-empty rectangular grid of devices, got {devices}")
        self.devices = grid

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def n_model(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def first(self) -> torch.device:
        """Where gathered arrays land: the host reads them from here."""
        return self.devices[0][0]

    def device(self, d: int, m: int) -> torch.device:
        return self.devices[d][m]

    def coords(self) -> List[Coord]:
        return [(d, m) for d in range(self.n_data) for m in range(self.n_model)]

    def distinct(self) -> List[torch.device]:
        """The grid's devices, each once, in grid order."""
        return list(dict.fromkeys(itertools.chain.from_iterable(self.devices)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(x) for x in row] for row in self.devices]})"


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None, devices=None) -> Mesh:
    """A mesh of n_data x n_model over `devices` (default: every CUDA card,
    as jax.devices()); n_model defaults to MESH_NUM_MODEL_SHARDS, n_data to
    as many rows as the devices fill. A list with a device repeated gives a
    logical mesh, e.g. ``make_mesh(2, 2, [torch.device("cuda", 0)] * 4)``."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(x) for x in devices]
    n_model = n_model or settings.MESH_NUM_MODEL_SHARDS
    n_data = n_data or len(devices) // n_model
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} devices, got {len(devices)}")
    return Mesh([devices[d * n_model:(d + 1) * n_model] for d in range(n_data)])


def kernel_shardable(mesh: Mesh, batch: int, *head_counts: int) -> bool:
    """True when the per-shard kernels can take these dims: the data axis
    divides the batch and the model axis every head count. Otherwise the
    dispatchers run the single-device kernel on the gathered batch."""
    if batch % mesh.n_data:
        return False
    return mesh.n_model == 1 or all(h % mesh.n_model == 0 for h in head_counts)


def split_sizes(n: int, parts: int) -> List[int]:
    """The sizes torch.tensor_split gives n items in `parts`: the first n % parts one longer."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of part `index` of n items split as split_sizes."""
    sizes = split_sizes(n, parts)
    start = sum(sizes[:index])
    return start, start + sizes[index]


def _own(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of x on device that shares no memory with it."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    out.copy_(x)
    return out


class Sharded:
    """A global array as per-shard tensors: ``shards[(d, m)]`` on
    ``mesh.device(d, m)``. ``spec`` has one entry a dimension, as a JAX
    PartitionSpec: DATA_AXIS or MODEL_AXIS where that axis splits the
    dimension, None where every shard holds all of it."""

    __slots__ = ("mesh", "spec", "shards")

    def __init__(self, mesh: Mesh, spec: tuple, shards: Dict[Coord, torch.Tensor]):
        self.mesh, self.spec, self.shards = mesh, tuple(spec), shards

    def __getitem__(self, dm: Coord) -> torch.Tensor:
        return self.shards[dm]

    def dim_of(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None

    def global_size(self, dim: int) -> int:
        axis = self.spec[dim]
        if axis == DATA_AXIS:
            return sum(self.shards[d, 0].shape[dim] for d in range(self.mesh.n_data))
        if axis == MODEL_AXIS:
            return sum(self.shards[0, m].shape[dim] for m in range(self.mesh.n_model))
        return self.shards[0, 0].shape[dim]

    @classmethod
    def split(cls, x: torch.Tensor, mesh: Mesh, spec: tuple) -> "Sharded":
        """x split by spec, each shard a copy of its own on its device."""
        shards = {}
        for d, m in mesh.coords():
            piece = x
            for dim, axis in enumerate(spec):
                if axis == DATA_AXIS:
                    piece = piece.tensor_split(mesh.n_data, dim)[d]
                elif axis == MODEL_AXIS:
                    piece = piece.tensor_split(mesh.n_model, dim)[m]
            shards[d, m] = _own(piece, mesh.device(d, m))
        return cls(mesh, spec, shards)

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The global array on `device` (default the mesh's first): shards
        joined along their split dimensions, shard (d, 0) and (0, m) read
        along a dimension that is replicated."""
        device = device or self.mesh.first
        dd, md = self.dim_of(DATA_AXIS), self.dim_of(MODEL_AXIS)
        rows = []
        for d in range(self.mesh.n_data if dd is not None else 1):
            parts = [self.shards[d, m].to(device) for m in range(self.mesh.n_model if md is not None else 1)]
            rows.append(torch.cat(parts, md) if md is not None else parts[0])
        return torch.cat(rows, dd) if dd is not None else rows[0]


# -- collectives ---------------------------------------------------------------

def all_reduce_sum(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The row-parallel sum of one data row: every model shard gets the sum
    of the shards' partial products on its own device, added in model-index
    order, so that every shard holds the same bits."""
    out = []
    for dev in devices:
        acc = parts[0].to(dev)
        for p in parts[1:]:
            acc = acc + p.to(dev)
        out.append(acc)
    return out


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Data-sharded outputs, one a data shard, joined on `device` for the host."""
    return torch.cat([p.to(device) for p in parts]) if len(parts) > 1 else parts[0].to(device)


# -- the decoder's tensor-parallel plan (surya_tpu _decoder_tp_spec) ------------

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")  # output features split
ROW = ("o_proj", "down_proj")  # input features split; partial products summed


def slice_linear(lin: nn.Module, name: str, index: int, parts: int, unit: int, device) -> nn.Module:
    """Part `index` of `parts` of a Linear or QuantLinear named `name`, on
    device. A column layer keeps its slice of the output features (weight
    rows, bias, int8 scales); a row layer its slice of the input features
    (weight columns), its scale and bias whole: they apply after the sum
    (row_epilogue). Slices are whole units of `unit` features (a head's for
    the attention projections). With one part on the layer's own device the
    layer itself is returned."""
    if name not in COLUMN + ROW:
        raise ValueError(f"{name} is not a projection of the decoder's TP plan")
    quant = isinstance(lin, QuantLinear)
    weight = lin.weight_q if quant else lin.weight
    device = torch.device(device)
    if parts == 1 and weight.device == device:
        return lin
    dim = 0 if name in COLUMN else 1
    lo, hi = (unit * i for i in split_range(weight.shape[dim] // unit, parts, index))
    out_f, in_f = (hi - lo, weight.shape[1]) if dim == 0 else (weight.shape[0], hi - lo)
    has_bias = lin.bias is not None
    with torch.device(device):
        part = QuantLinear(in_f, out_f, bias=has_bias) if quant else nn.Linear(in_f, out_f, bias=has_bias,
                                                                              dtype=weight.dtype)
    with torch.no_grad():
        (part.weight_q if quant else part.weight).copy_(weight.narrow(dim, lo, hi - lo))
        if quant:
            part.scale.copy_(lin.scale[lo:hi] if dim == 0 else lin.scale)
        if has_bias:
            part.bias = nn.Parameter(_own(lin.bias[lo:hi] if dim == 0 else lin.bias, device).to(lin.bias.dtype),
                                     requires_grad=False)
    return part.requires_grad_(False)


def row_matmul(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A row layer's partial product: x times its weight slice, no scale, no bias."""
    return F.linear(x, lin.weight_q.to(x.dtype) if isinstance(lin, QuantLinear) else lin.weight)


def row_epilogue(lin: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """What a row layer applies after the sum: the int8 scale, then the bias,
    rounded as QuantLinear and nn.Linear round them."""
    if isinstance(lin, QuantLinear):
        y = y * lin.scale.to(y.dtype)
    return y if lin.bias is None else y + lin.bias


# -- placement of the foundation model ----------------------------------------

def replicate(module: nn.Module, device, skip: Sequence[nn.Module] = ()) -> nn.Module:
    """A copy of `module` on device whose parameters and buffers are moved
    there once (the module itself when it is there already); the submodules
    in `skip` are left out (None in the copy)."""
    device = torch.device(device)
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    if skip == () and all(t.device == device for t in tensors):
        return module
    skipped = {id(t) for m in skip for t in itertools.chain(m.parameters(), m.buffers())}
    memo = {id(m): None for m in skip}
    for t in tensors:
        if id(t) not in skipped and id(t) not in memo:
            moved = t.detach().to(device)
            memo[id(t)] = nn.Parameter(moved, requires_grad=False) if isinstance(t, nn.Parameter) else moved
    return copy.deepcopy(module, memo)


class Placement:
    """The foundation model on a mesh: its replicated parameters once a
    distinct device (``replicas``; the model itself on its own device), and the decoder's TP slices once a (device, model index)
    (``decoder_shard(d, m)``, qwen_decoder.DecoderShard). With one model
    shard a decoder shard is the replica's whole decoder."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        from surya_tpu_torch.models.qwen_decoder import DecoderShard

        self.mesh = mesh
        n = mesh.n_model
        own = next(model.parameters()).device
        # the decoder's projections go to the slices, not to other devices' replicas
        skip = [m for layer in model.decoder.layers for m in (layer.self_attn, layer.mlp)] if n > 1 else []
        self.replicas = {dev: model if dev == own else replicate(model, dev, skip) for dev in mesh.distinct()}
        slices = {}
        for d, m in mesh.coords():
            dev = mesh.device(d, m)
            if (dev, m) not in slices:
                slices[dev, m] = DecoderShard(model.decoder, self.replicas[dev].decoder, m, n, dev)
        self._decoder = {(d, m): slices[mesh.device(d, m), m] for d, m in mesh.coords()}

    def model(self, d: int, m: int) -> nn.Module:
        """The replicated model that shard (d, m) runs (its device's)."""
        return self.replicas[self.mesh.device(d, m)]

    def decoder_shard(self, d: int, m: int):
        return self._decoder[d, m]
