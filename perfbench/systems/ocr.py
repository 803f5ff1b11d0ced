"""OCR through surya_tpu_torch's RecognitionPredictor: whole pages with
the DetectionPredictor (``whole_page`` calls) or the line boxes the
benchmark drew (``given_lines`` calls), decode pinned at the mix's
``decode_tokens`` a line.

The judged outputs are the program's own: the crops and the token ids it
served for every line, taken as it assembles its results, and the line
polygons its detection found. After the window the reference reads them
only to judge them (``check``).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.counts import ocr as counts
from perfbench.reference import foundation as ref
from perfbench.reference import precision

STAGE_PREFIXES = ("recognition.", "detection.")
DETECTION_WEIGHT_SEED = 0x5EED  # the detector's weights: seed + this, a stream of their own


def program_control(cfg: dict, control: bool) -> bool:
    """The control is the program's own int8 path (int8 decoder weights and
    KV cache) where the configuration states bfloat16; below float32 it is
    the reference in bfloat16, in the program's place in the check."""
    return control and cfg["model"]["dtype"] == "bfloat16"


def environment(cfg: dict, mix: dict, control: bool) -> Dict[str, str]:
    """The program's settings for this cell (read when it is imported)."""
    s = cfg["serving"]
    return {
        "RECOGNITION_MAX_TOKENS": str(mix["decode_tokens"]),
        "RECOGNITION_PIN_DECODE": "true",
        "RECOGNITION_DECODE_CHUNK": str(s["decode_chunk"]),
        "RECOGNITION_BATCH_SIZE": str(s["slots"]),
        # the control: int8 KV cache (and, in System, int8 decoder weights)
        "RECOGNITION_MODEL_QUANTIZE": "true" if program_control(cfg, control) else "false",
        "RECOGNITION_WEIGHT_QUANTIZE": "false",
    }


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, control: bool = False, tiny: bool = False):
        from surya_tpu_torch.detection import DetectionPredictor
        from surya_tpu_torch.models import qwen_decoder
        from surya_tpu_torch.models.efficientvit import install_blob_detector
        from surya_tpu_torch.recognition import RecognitionPredictor

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.model_cfg = cfg["model"]
        self.whole_page = mix["call"] == "whole_page"
        if mix["call"] not in ("whole_page", "given_lines"):
            raise ValueError(f"an OCR configuration cannot serve {mix['call']} calls")
        kw = {"device": self.device}
        self.rec = RecognitionPredictor(None, tiny, **kw)
        check_config(self.rec.config, self.model_cfg)
        shapes = ref.param_shapes(self.model_cfg)
        self.weights_seed = cfg["weights"]["seed"]
        self.rec.model.load_state_dict(weights.make(shapes, self.weights_seed, self.device, self.rec.dtype),
                                       strict=True)
        if program_control(cfg, control):
            qwen_decoder.quantize_weights(self.rec.model.decoder)
        self.reference_control = control and not program_control(cfg, control)
        self.det = None
        if self.whole_page:
            self.det = DetectionPredictor(None, tiny, **kw)
            det_shapes = {k: tuple(v.shape) for k, v in self.det.model.state_dict().items() if v.is_floating_point()}
            self.det.model.load_state_dict(
                weights.make(det_shapes, self.weights_seed + DETECTION_WEIGHT_SEED, self.device, self.det.dtype,
                             scale=0.02),
                strict=False)  # the port's own init scale: the blob hook, not these weights, finds the lines
            install_blob_detector(self.det)
        self.pool = traffic.page_pool(mix, seed + 1)
        self.calls = max(1, len(self.pool) // mix["pages_per_call"])
        self.inputs = [self._call_inputs(k) for k in range(self.calls)]
        self.records: List[dict] = []
        self.recording = False
        assemble = self.rec._assemble_results

        def recorder(images, flat, predicted_tokens, scores, bbox_arr, **kw):
            if self.recording:
                self.records.append({"slices": list(flat["slices"]), "polygons": list(flat["polygons"]),
                                     "slice_map": list(flat["slice_map"]),
                                     "tokens": [list(t) for t in predicted_tokens],
                                     "scores": [list(s) for s in scores]})
            with torch.profiler.record_function("perfbench.ocr.assemble_results"):
                return assemble(images, flat, predicted_tokens, scores, bbox_arr, **kw)

        self.rec._assemble_results = recorder
        # a range around the scheduler, so that a trace names the host time
        # between its stages
        self.rec.prediction_loop = ranged("perfbench.ocr.prediction_loop", self.rec.prediction_loop)

    def _call_inputs(self, k: int):
        pages = traffic.call_pages(self.mix, self.pool, k)
        images = [p.image for p in pages]
        if self.whole_page:
            return images, None
        pad = self.mix["line_pad"]
        polys = [[[[x0 - pad, y0 - pad], [x1 + pad, y0 - pad], [x1 + pad, y1 + pad], [x0 - pad, y1 + pad]]
                  for x0, y0, x1, y1 in p.lines] for p in pages]
        return images, polys

    # -- the timed path ------------------------------------------------------------

    def distinct_calls(self) -> int:
        """Calls of different inputs: the window cycles through them."""
        return self.calls

    def call(self, k: int) -> int:
        """Call k of the run; returns the pages it served."""
        images, polys = self.inputs[k % self.calls]
        if self.whole_page:
            out = self.rec(images, det_predictor=self.det)
        else:
            out = self.rec(images, polygons=polys)
        if len(out) != len(images):
            raise RuntimeError(f"{len(out)} results for {len(images)} pages")
        return len(images)

    def reset_counters(self) -> None:
        """OCR's per-layer metrics read the program's spans, not counters."""

    def counters(self) -> dict:
        return {}

    def captures(self) -> int:
        """CUDA graphs captured so far (0 where none are)."""
        stores = [self.rec.programs, self.rec.loops] + ([self.det.programs] if self.det is not None else [])
        return sum(len(getattr(s, "captures", {})) for s in stores)

    def release(self) -> None:
        """Drop the program's state (its predictors, graphs and caches)."""
        self.rec = self.det = None
        self.inputs = None

    # -- what the recorded calls need --------------------------------------------

    def _pages_of(self, k: int) -> List[traffic.Page]:
        return traffic.call_pages(self.mix, self.pool, k)

    def work(self, call_indices) -> Dict[str, float]:
        """The operations and bytes of the recorded calls `call_indices`."""
        c = self.model_cfg
        e = c["encoder"]
        per_line = []
        for k in call_indices:
            r = self.records[k]
            for crop, toks in zip(r["slices"], r["tokens"]):
                grid = ref.fitted_grid(crop.shape, tuple(c["line_image_size"]), e["patch_size"],
                                       e["spatial_merge_size"])
                n_tok = grid[0] * grid[1] // e["spatial_merge_size"] ** 2
                per_line.append(counts.line_work(c, grid, len(ref.prompt_ids(c, n_tok)), len(toks)))
        return counts.total(per_line)

    # -- correctness -------------------------------------------------------------

    def check(self, tolerances: dict) -> Dict[str, float]:
        """The numbers compared, each worst over what it covers:
        det_line_errors (whole pages: drawn lines not found by exactly one
        detected box, and boxes that hold no drawn line or several, over
        every page of every recorded call), crop_diff (the largest pixel
        difference between the program's crop of a sampled line and the
        reference's) and bad_tokens (the sampled lines' served tokens at
        which the reference finds the program off by more than
        tolerances["token"]: the token's logit lies that far below the
        reference's best, or the log-probability the program gave the token
        it chose, which it reports as the token's score, differs that much
        from the reference's log-probability of its own first choice).
        Where the control is the reference's, its first tokens and their
        probabilities stand in for the program's."""
        if not self.records:
            raise RuntimeError("no call was recorded")
        c = self.model_cfg
        e = c["encoder"]
        numbers = {}
        if self.whole_page:
            errors = 0
            for k, r in enumerate(self.records):
                start = 0
                for page, n in zip(self._pages_of(k), r["slice_map"]):
                    errors += line_errors(page.lines, r["polygons"][start : start + n])
                    start += n
            numbers["det_line_errors"] = float(errors)
        lines = [(k, i) for k, r in enumerate(self.records) for i in range(len(r["slices"]))]
        rng = np.random.default_rng(self.seed + 2)
        pick = set(rng.choice(len(lines), size=min(self.mix["sample_lines"], len(lines)), replace=False).tolist())
        pick.add(max(range(len(lines)), key=lambda j: self.records[lines[j][0]]["slices"][lines[j][1]].size))
        W = {k: v.float() for k, v in weights.make(ref.param_shapes(c), self.weights_seed, self.device,
                                                    getattr(torch, c["dtype"])).items()}
        tau = tolerances["token"]
        crop_diff, gap, logp, flips, bad, worst = 0.0, 0.0, 0.0, 0, 0, []
        with torch.no_grad(), no_tf32():
            for j in sorted(pick):
                k, i = lines[j]
                r = self.records[k]
                page_idx = int(np.searchsorted(np.cumsum(r["slice_map"]), i, side="right"))
                page = np.asarray(self._pages_of(k)[page_idx].image)
                crop = ref.slice_polygon(page, r["polygons"][i])
                mine = r["slices"][i]
                crop_diff = max(crop_diff, float(np.abs(crop.astype(np.int32) - mine.astype(np.int32)).max())
                                if crop.shape == mine.shape else float("inf"))
                x, grid = ref.patches(ref.scale_to_fit(crop, tuple(c["line_image_size"])), e["patch_size"],
                                      e["spatial_merge_size"])
                image_tokens = ref.encode(W, c, x.to(self.device), grid)
                served = r["tokens"][i]
                prompt = ref.prompt_ids(c, image_tokens.shape[0])
                lg = ref.logits(W, c, image_tokens, prompt, served)
                ref_top = (lg.max(-1).values - torch.logsumexp(lg, -1)).double()
                if self.reference_control:  # what the lower precision puts first, and its probability
                    low = precision.LowPrecision(W, precision.LOWER[c["dtype"]])
                    lg_low = ref.logits(low, c, ref.encode(low, c, x.to(self.device), grid), prompt, served)
                    idx = lg_low.argmax(-1)
                    top = (lg_low.max(-1).values - torch.logsumexp(lg_low, -1)).double()
                else:
                    idx = torch.tensor(served, device=self.device)
                    # the program's probability of its token (0 where it served EOS or PAD)
                    score = torch.tensor(r["scores"][i], device=self.device, dtype=torch.float64)
                    keep = score > 0
                    top = torch.where(keep, score.clamp(min=1e-300).log(), ref_top)
                token_gap = lg.max(-1).values - lg[torch.arange(len(served)), idx]
                logp_err = (top - ref_top).abs()
                gap, logp = max(gap, float(token_gap.max())), max(logp, float(logp_err.max()))
                bad += int(((token_gap > tau) | (logp_err > tau)).sum())
                flips += int((lg.argmax(-1) != idx).sum())
                worst.append(torch.maximum(token_gap.double(), logp_err).cpu())
        served = [t for j in pick for t in self.records[lines[j][0]]["tokens"][lines[j][1]]]
        worst = torch.cat(worst)
        print(f"perfbench: {len(pick)} lines checked, {len(served)} tokens, {len(set(served))} distinct, "
              f"{flips} not the reference's first; widest token gap {gap!r}, widest log-probability error "
              f"{logp!r}; rms of the larger {float(worst.square().mean().sqrt())!r}; tokens over 0.03 to 0.07: "
              f"{[int((worst > t).sum()) for t in (0.03, 0.035, 0.04, 0.045, 0.05, 0.055, 0.06, 0.065, 0.07)]}",
              file=sys.stderr)
        numbers["crop_diff"] = crop_diff
        numbers["bad_tokens"] = float(bad)
        return numbers


def ranged(name: str, fn):
    """fn inside a profiler range of `name` (a host range a trace shows)."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call


class no_tf32:
    """float32 products in float32 (TF32 off) inside the block."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def line_errors(drawn, polygons, cover: float = 0.9) -> int:
    """Drawn lines (ink boxes) that are not covered, to `cover` of their area,
    by exactly one detected box, plus detected boxes that cover no drawn line
    or several."""
    boxes = np.array([[min(p[0] for p in q), min(p[1] for p in q), max(p[0] for p in q), max(p[1] for p in q)]
                      for q in polygons], np.float64).reshape(-1, 4)
    ink = np.asarray(drawn, np.float64).reshape(-1, 4)
    ix = np.clip(np.minimum(ink[:, None, 2], boxes[None, :, 2]) - np.maximum(ink[:, None, 0], boxes[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(ink[:, None, 3], boxes[None, :, 3]) - np.maximum(ink[:, None, 1], boxes[None, :, 1]), 0, None)
    area = ((ink[:, 2] - ink[:, 0]) * (ink[:, 3] - ink[:, 1]))[:, None]
    covers = ix * iy >= cover * area
    return int((covers.sum(1) != 1).sum() + (covers.sum(0) != 1).sum())


def check_config(port_cfg, cfg: dict) -> None:
    """The program's model must have the configuration file's widths and tokens."""
    e, d = port_cfg.encoder, port_cfg.decoder
    want = cfg
    got = {
        "vocab_size": port_cfg.vocab_size, "image_embed_encoding_size": port_cfg.image_embed_encoding_size,
        "image_embed_encoding_multiplier": port_cfg.image_embed_encoding_multiplier,
        "encoder": {k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(e).items() if k in want["encoder"]},
        "decoder": {k: v for k, v in vars(d).items() if k in want["decoder"]},
        "tokens": {"eos": port_cfg.eos_token_id, "pad": port_cfg.pad_token_id, "image": port_cfg.image_token_id},
    }
    for key, value in got.items():
        expect = want[key]
        if isinstance(value, dict):
            expect = {k: want[key][k] for k in value}
        if value != expect:
            raise RuntimeError(f"the program's {key} is {value}, the configuration's {expect}")
