"""Random weights from a seed, made on the device in one call to the
generator and handed alike to the program and to the reference. The seed
is the configuration's (``weights.seed``), not the run's: a model's random
outputs set how much work the host does after it (layout's clean-up and
joining of overlapping boxes, OCR's detokenization), so that a model drawn
anew for every run would change the work from seed to seed. The run's seed
draws the pages.

With the scale "fan_in" (a configuration's ``weights.scale``), a matrix or
kernel is N(0, 1 / fan_in) (its inputs: the product of every axis but the
first), an embedding table N(0, 1 / width), so that every layer passes on
about the spread it is given and the model's choices depend on all of its
input, as a trained model's do, and not on the token fed back alone. With a
number, every matrix is N(0, number^2). A vector named ``weight`` (a norm's
scale) is 1 + N(0, 0.02^2), every other vector (a bias) N(0, 0.02^2). All
are rounded to the type the model is served in.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch

VECTOR_STD = 0.02


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device, dtype,
         scale: Union[str, float] = "fan_in") -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    with torch.no_grad():
        for name, shape in shapes.items():
            n = math.prod(shape)
            t = flat[at : at + n].view(shape)
            at += n
            if len(shape) == 1:
                t = t * VECTOR_STD + (1.0 if name.endswith("weight") else 0.0)
            elif scale == "fan_in":  # an embedding table's fan-in is its row's width
                t = t * (1.0 / math.sqrt(math.prod(shape[1:])))
            else:
                t = t * float(scale)
            out[name] = t
    return out
