"""Layout through surya_tpu_torch's LayoutPredictor, its box loop pinned:
the class ids of EOS and PAD taken out of the configuration, so that no
tile stops early, and ``max_boxes`` set to the mix's ``max_boxes``.

The judged outputs are the program's own: each tile's box tokens (the six
box values and the class of every step) as the predictor fetches them,
before it cleans and joins them. After the window the reference works out
the tiles from the pages again and runs them (``check``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.counts import layout as counts
from perfbench.reference import layout as ref
from perfbench.reference import precision
from perfbench.systems.ocr import no_tf32, ranged

STAGE_PREFIXES = ("layout.",)


def environment(cfg: dict, mix: dict, control: bool) -> Dict[str, str]:
    return {"LAYOUT_BATCH_SIZE": str(cfg["serving"]["batch_tiles"]),
            "LAYOUT_PIPELINE_BATCH": str(cfg["serving"]["dispatch_tiles"])}


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, control: bool = False, tiny: bool = False):
        from surya_tpu_torch.layout import LayoutPredictor
        from surya_tpu_torch.layout.loader import layout_config

        if mix["call"] != "layout":
            raise ValueError(f"a layout configuration cannot serve {mix['call']} calls")
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.model_cfg = cfg["model"]
        # the control: the program has no lower-precision path, so the
        # reference in the next lower precision takes its place in the check
        self.control = control
        pinned = dataclasses.replace(layout_config(tiny), eos_token_id=-1, pad_token_id=-1,
                                     max_boxes=mix["max_boxes"])
        self.lay = LayoutPredictor(None, tiny, device=self.device, config=pinned)
        check_config(self.lay.config, self.model_cfg)
        shapes = ref.param_shapes(self.model_cfg)
        self.weights_seed = cfg["weights"]["seed"]
        self.lay.model.load_state_dict(weights.make(shapes, self.weights_seed, self.device, self.lay.dtype),
                                       strict=True)
        self.pool = traffic.page_pool(mix, seed + 1)
        self.calls = max(1, len(self.pool) // mix["pages_per_call"])
        self.records: List[dict] = []
        self.recording = False
        self.reset_counters()
        assemble = self.lay._assemble_batch

        def recorder(boxes, logits, valid, orig_sizes, tile_positions, slicer, top_k):
            if self.recording:
                self.records[-1]["batches"].append({"boxes": np.array(boxes), "valid": np.array(valid),
                                                    "positions": list(tile_positions)})
            with torch.profiler.record_function("perfbench.layout.assemble_batch"):
                return assemble(boxes, logits, valid, orig_sizes, tile_positions, slicer, top_k)

        self.lay._assemble_batch = recorder
        # ranges around the host's work per tile and per dispatch, so that a
        # trace names the host time that leaves the card idle
        self.lay.prepare_image = ranged("perfbench.layout.prepare_image", self.lay.prepare_image)
        self.lay._finish = ranged("perfbench.layout.finish", self.lay._finish)

    def distinct_calls(self) -> int:
        return self.calls

    def call(self, k: int) -> int:
        pages = traffic.call_pages(self.mix, self.pool, k % self.calls)
        if self.recording:
            self.records.append({"call": k % self.calls, "batches": []})
        out = self.lay([p.image for p in pages])
        if len(out) != len(pages) or any(r.image_bbox != [0, 0, *p.image.size] for r, p in zip(out, pages)):
            raise RuntimeError("the layout results do not match the pages")
        if self.lay.last_run["steps"] != [self.mix["max_boxes"]] * len(self.lay.last_run["tiles"]):
            raise RuntimeError(f"the box loop ran {self.lay.last_run['steps']} steps, not {self.mix['max_boxes']}")
        self._counts["enqueue_s"] += self.lay.last_run["enqueue_s"]
        return len(pages)

    def reset_counters(self) -> None:
        self._counts = {"enqueue_s": 0.0}

    def counters(self) -> dict:
        return dict(self._counts)

    def captures(self) -> int:
        return len(getattr(self.lay.loops, "captures", {}))

    def release(self) -> None:
        self.lay = None

    def _tiles(self, k: int):
        """(page index in the call, tile) of every tile of recorded call k, in order."""
        r = self.records[k]
        pages = traffic.call_pages(self.mix, self.pool, r["call"])
        out, first = [], 0
        for b in r["batches"]:
            rel = [p[0] for p in b["positions"]]
            for j, idx in enumerate(rel):
                out.append((first + idx, b, j))
            first += max(rel) + 1
        return pages, out

    def work(self, call_indices) -> Dict[str, float]:
        tiles = sum(len(self._tiles(k)[1]) for k in call_indices)
        w = counts.tile_work(self.model_cfg, self.mix["max_boxes"])
        return {k: v * tiles for k, v in w.items()}

    def check(self, tolerances: dict) -> Dict[str, float]:
        """box_diff: the largest difference of a served box value (0 to
        bbox_size) from the reference's at the same step, fed the same
        boxes; class_gap: the widest gap by which a served class's logit
        lies below the reference's best (the header/footer rule applied or
        not, whichever gives the smaller gap). Over every step of the tiles
        sampled from the recorded calls. The control: the reference's boxes
        and classes in the next lower precision (fp8 below bfloat16), fed
        the same boxes, in place of the served ones."""
        if not self.records:
            raise RuntimeError("no call was recorded")
        c = self.model_cfg
        every = [(k, t) for k in range(len(self.records)) for t in range(len(self._tiles(k)[1]))]
        rng = np.random.default_rng(self.seed + 2)
        pick = sorted(rng.choice(len(every), size=min(self.mix["sample_tiles"], len(every)), replace=False).tolist())
        W = {k: v.float() for k, v in weights.make(ref.param_shapes(c), self.weights_seed, self.device,
                                                    getattr(torch, c["dtype"])).items()}
        low = precision.LowPrecision(W, precision.LOWER[c["dtype"]])
        box_diff, class_gap = 0.0, 0.0
        with torch.no_grad(), no_tf32():
            for j in pick:
                k, t = every[j]
                pages, tiles = self._tiles(k)
                page_idx, batch, row = tiles[t]
                index_in_page = sum(1 for p, _, _ in tiles[:t] if p == page_idx)
                tile = ref.tiles(pages[page_idx].image, c)[index_in_page]
                served = torch.from_numpy(batch["boxes"][row]).to(self.device)  # [MAX, 7]
                if not bool(batch["valid"][row].all()):
                    raise RuntimeError("a pinned tile stopped early")
                feeds = torch.cat([torch.full((1, 7), c["bos_token_id"], device=self.device),
                                   served[:-1].to(torch.int32).float()]).long()
                lg, box = ref.decode(W, c, ref.encode(W, c, tile, self.device), feeds)
                if self.control:
                    lg8, box8 = ref.decode(low, c, ref.encode(low, c, tile, self.device), feeds)
                    served = torch.cat([box8, final_class(c, lg8, box8)[:, None].float()], -1)
                box_diff = max(box_diff, float((box - served[:, :6]).abs().max()))
                class_gap = max(class_gap, gap_of(c, lg, box, served[:, 6].long()))
        return {"box_diff": box_diff, "class_gap": class_gap}


def rewritten(cfg: dict, lg: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """The class logits after the header/footer rule: the top class's logit
    set to 0 where the rule applies, as the program's box loop sets it."""
    top = lg.argmax(-1)
    rule = ref.header_footer_rule(cfg, box, top)
    return lg.masked_fill(rule[:, None] & (torch.arange(lg.shape[1], device=lg.device)[None] == top[:, None]), 0.0)


def final_class(cfg: dict, lg: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return rewritten(cfg, lg, box).argmax(-1)


def gap_of(cfg: dict, lg: torch.Tensor, box: torch.Tensor, cls: torch.Tensor) -> float:
    """The widest gap of the classes `cls` below the best of the reference's
    logits lg, the rule applied or not, whichever is smaller at a step."""
    rows = torch.arange(len(cls), device=lg.device)
    raw = lg.max(-1).values - lg[rows, cls]
    rew = rewritten(cfg, lg, box)
    return float(torch.minimum(raw, rew.max(-1).values - rew[rows, cls]).max())


def check_config(port_cfg, cfg: dict) -> None:
    e, d = port_cfg.encoder, port_cfg.decoder

    def plain(v):
        return list(v) if isinstance(v, tuple) else v

    got = {"vocab_size": port_cfg.vocab_size, "bbox_size": port_cfg.bbox_size, "label_count": port_cfg.label_count,
           "encoder": {k: plain(v) for k, v in vars(e).items() if k in cfg["encoder"]},
           "decoder": {k: plain(v) for k, v in vars(d).items() if k in cfg["decoder"]}}
    for key, value in got.items():
        if value != cfg[key]:
            raise RuntimeError(f"the program's {key} is {value}, the configuration's {cfg[key]}")
