"""OCR through surya_tpu_torch's RecognitionPredictor with LFM2-8B-A1B's
language model as the recognition foundation model's decoder
(configuration lfm2_8b_a1b_ocr): the line boxes the benchmark drew are
given (``given_lines`` calls), decode pinned at the mix's ``decode_tokens``
a line, as systems/ocr.py runs them for surya_ocr.

The predictor is built from the configuration (``RecognitionPredictor(
config=...)``: a config.json whose decoder is the top-level keys of the
configuration file, with ``model_type`` "lfm2_moe"), its random weights
drawn by weights.make under the checkpoint's names (one tensor an expert)
and stacked as the program holds them.

The judged outputs are the program's own crops and served tokens, which
the reference (reference/lfm2.py) reads after the window (``check``). The
control is the reference in fp8 (precision.LowPrecision) in the program's
place: the program has no lower-precision path for this decoder.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.counts import lfm2 as counts
from perfbench.counts import ocr as ocr_counts
from perfbench.reference import foundation as fref
from perfbench.reference import lfm2 as ref
from perfbench.reference import precision
from perfbench.systems import ocr

STAGE_PREFIXES = ocr.STAGE_PREFIXES
# the configuration file's keys that are not the language model's config.json keys
META = ("name", "system", "rate_metric", "source", "deployment", "model", "serving", "weights", "assumed")
MOE_COUNTERS = ("rows", "experts_hit", "rows_max")  # recognition.moe_<name>
ENCODER_KEYS = ("depth", "hidden_size", "intermediate_size", "num_heads", "patch_size", "spatial_merge_size",
                "window_size", "out_hidden_size", "fullatt_block_indexes")


def model_config(cfg: dict) -> dict:
    """The configuration's "model" entry with its "decoder": the language
    model's keys, the file's top level."""
    return dict(cfg["model"], decoder={k: v for k, v in cfg.items() if k not in META})


def program_config(cfg: dict) -> dict:
    """The config.json the program is built from."""
    m = model_config(cfg)
    t = m["tokens"]
    return {"vocab_size": m["vocab_size"], "eos_token_id": t["eos"], "pad_token_id": t["pad"],
            "image_token_id": t["image"], "image_embed_encoding_size": m["image_embed_encoding_size"],
            "image_embed_encoding_multiplier": m["image_embed_encoding_multiplier"],
            "vision_encoder": {k: m["encoder"][k] for k in ENCODER_KEYS}, "decoder": m["decoder"]}


def environment(cfg: dict, mix: dict, control: bool) -> Dict[str, str]:
    """The program's settings for this cell: systems/ocr.py's, bf16 weights
    and cache whatever the control (which is the reference's)."""
    return ocr.environment(cfg, mix, False)


class System(ocr.System):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, control: bool = False, tiny: bool = False):
        from surya_tpu_torch.models import lfm2_decoder
        from surya_tpu_torch.recognition import RecognitionPredictor

        if mix["call"] != "given_lines":
            raise ValueError(f"{cfg['name']} serves given_lines calls, not {mix['call']}")
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.model_cfg = model_config(cfg)
        self.whole_page = False
        self.rec = RecognitionPredictor(None, device=self.device, config=program_config(cfg))
        check_config(self.rec.config.decoder, self.model_cfg["decoder"])
        self.weights_seed = cfg["weights"]["seed"]
        state = weights.make(ref.param_shapes(self.model_cfg), self.weights_seed, self.device, self.rec.dtype)
        self.rec.model.load_state_dict(lfm2_decoder.stack_experts(state, self.rec.config.decoder), strict=True)
        del state
        self.reference_control = control
        self.det = None
        self.pool = traffic.page_pool(mix, seed + 1)
        self.calls = max(1, len(self.pool) // mix["pages_per_call"])
        self.inputs = [self._call_inputs(k) for k in range(self.calls)]
        self.records = []
        self.recording = False
        self.call_moe: Dict[int, Dict[str, int]] = {}  # call -> its sparse layers' counters
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
        self.rec.prediction_loop = ocr.ranged("perfbench.ocr.prediction_loop", self.rec.prediction_loop)

    def call(self, k: int) -> int:
        """Call k (systems/ocr.py's); a recorded call keeps the counts of the
        sparse layers' work that the program reported for it."""
        before = moe_counts()
        n = super().call(k)
        if self.recording:
            after = moe_counts()
            self.call_moe[k] = {name: after[name] - before[name] for name in MOE_COUNTERS}
        return n

    def work(self, call_indices) -> Dict[str, float]:
        """The operations and bytes of the recorded calls `call_indices`: each
        line's (counts/lfm2.line_work), and the expert GEMMs' from the calls'
        own counters (counts/lfm2.moe_work), with the number of experts."""
        c = self.model_cfg
        e = c["encoder"]
        per_line = []
        for k in call_indices:
            r = self.records[k]
            for crop, toks in zip(r["slices"], r["tokens"]):
                grid = fref.fitted_grid(crop.shape, tuple(c["line_image_size"]), e["patch_size"],
                                        e["spatial_merge_size"])
                n_tok = grid[0] * grid[1] // e["spatial_merge_size"] ** 2
                per_line.append(counts.line_work(c, grid, len(fref.prompt_ids(c, n_tok)), len(toks)))
        w = ocr_counts.total(per_line)
        moe = {name: sum(self.call_moe.get(k, {}).get(name, 0) for k in call_indices) for name in MOE_COUNTERS}
        if moe["rows"]:
            w.update(counts.moe_work(c, moe["rows"], moe["experts_hit"]))
        w["moe_experts"] = c["decoder"]["num_experts"]
        return w

    def check(self, tolerances: dict) -> Dict[str, float]:
        """The numbers compared, each worst over what it covers: crop_diff
        (as systems/ocr.py), bad_tokens (the sampled lines' served tokens at
        which the reference finds the program off by more than
        tolerances["token"], as systems/ocr.py counts them) and route_ties
        (such tokens whose position in the reference has a near tie of the
        routing in a sparse layer: a 4th and 5th biased router score less
        than tolerances["route_band"] apart, which the program's bf16
        rounding of the router's 2048-long input can turn over, so that the
        program rightly takes another expert than the reference; they are
        counted here and not among bad_tokens). Where the control is the
        reference's, its first tokens and their probabilities in fp8 stand in
        for the program's."""
        if not self.records:
            raise RuntimeError("no call was recorded")
        c = self.model_cfg
        e = c["encoder"]
        lines = [(k, i) for k, r in enumerate(self.records) for i in range(len(r["slices"]))]
        rng = np.random.default_rng(self.seed + 2)
        pick = set(rng.choice(len(lines), size=min(self.mix["sample_lines"], len(lines)), replace=False).tolist())
        pick.add(max(range(len(lines)), key=lambda j: self.records[lines[j][0]]["slices"][lines[j][1]].size))
        dtype = getattr(torch, c["dtype"])
        raw = weights.make(ref.param_shapes(c), self.weights_seed, self.device, dtype)
        W = ref.Float32(raw)  # each tensor cast to float32 as it is read
        tau, band = tolerances["token"], tolerances["route_band"]
        crop_diff, bad, ties, near, flips, worst, margins, gaps, errs = 0.0, 0, 0, 0, 0, [], [], [], []
        with torch.no_grad(), ocr.no_tf32():
            for j in sorted(pick):
                k, i = lines[j]
                r = self.records[k]
                page_idx = int(np.searchsorted(np.cumsum(r["slice_map"]), i, side="right"))
                page = np.asarray(self._pages_of(k)[page_idx].image)
                crop = fref.slice_polygon(page, r["polygons"][i])
                mine = r["slices"][i]
                crop_diff = max(crop_diff, float(np.abs(crop.astype(np.int32) - mine.astype(np.int32)).max())
                                if crop.shape == mine.shape else float("inf"))
                x, grid = fref.patches(fref.scale_to_fit(crop, tuple(c["line_image_size"])), e["patch_size"],
                                       e["spatial_merge_size"])
                x = x.to(self.device)
                image_tokens = fref.encode(W, c, x, grid)
                served = r["tokens"][i]
                prompt = fref.prompt_ids(c, image_tokens.shape[0])
                lg, margin = ref.logits(W, c, image_tokens, prompt, served)
                ref_top = (lg.max(-1).values - torch.logsumexp(lg, -1)).double()
                if self.reference_control:  # what fp8 products put first, and its probability
                    low = precision.LowPrecision(raw, precision.LOWER[c["dtype"]])
                    lg_low, _ = ref.logits(low, c, fref.encode(low, c, x, grid), prompt, served)
                    idx = lg_low.argmax(-1)
                    top = (lg_low.max(-1).values - torch.logsumexp(lg_low, -1)).double()
                else:
                    idx = torch.tensor(served, device=self.device)
                    score = torch.tensor(r["scores"][i], device=self.device, dtype=torch.float64)
                    top = torch.where(score > 0, score.clamp(min=1e-300).log(), ref_top)
                token_gap = lg.max(-1).values - lg[torch.arange(len(served)), idx]
                logp_err = (top - ref_top).abs()
                off = (token_gap > tau) | (logp_err > tau)
                tie = margin < band
                bad += int((off & ~tie).sum())
                ties += int((off & tie).sum())
                near += int(tie.sum())
                flips += int((lg.argmax(-1) != idx).sum())
                worst.append(torch.maximum(token_gap.double(), logp_err).cpu())
                margins.append(margin.cpu())
                gaps.append(token_gap.double().cpu())
                errs.append(logp_err.cpu())
        del W, raw
        n_tokens = sum(len(self.records[lines[j][0]]["tokens"][lines[j][1]]) for j in pick)
        worst, margins = torch.cat(worst), torch.cat(margins)
        for name, v in (("token gap", torch.cat(gaps)), ("log-probability error", torch.cat(errs))):
            print(f"perfbench: {name} quantiles 50/90/99/100 %: "
                  f"{[round(float(v.quantile(q)), 4) for q in (0.5, 0.9, 0.99, 1.0)]}; over 0.05/0.2/0.5/1/1.5/2/3: "
                  f"{[int((v > t).sum()) for t in (0.05, 0.2, 0.5, 1, 1.5, 2, 3)]}", file=sys.stderr)
        print(f"perfbench: {len(pick)} lines checked, {n_tokens} tokens, {flips} not the reference's first, {near} "
              f"at a routing margin under {band}; off by more than 0.03 to 0.2: "
              f"{[int((worst > t).sum()) for t in (0.03, 0.05, 0.07, 0.1, 0.2)]}; of those under "
              f"{tau}'s margin 0.001/0.002/0.005: "
              f"{[int(((worst > tau) & (margins < m)).sum()) for m in (1e-3, 2e-3, 5e-3)]}; "
              f"routing margin quantiles 1/10/50 %: "
              f"{[float(margins.quantile(q)) for q in (0.01, 0.1, 0.5)]}", file=sys.stderr)
        return {"crop_diff": crop_diff, "bad_tokens": float(bad), "route_ties": float(ties)}


def moe_counts() -> Dict[str, int]:
    """The program's sparse-layer counters so far (profiling's registry)."""
    from surya_tpu_torch.common import profiling

    stats = profiling.report(reset=False)
    return {name: stats.get(f"recognition.moe_{name}", {}).get("count", 0) for name in MOE_COUNTERS}


def check_config(port_decoder, decoder: dict) -> None:
    """The program's decoder must have the configuration's settings (the
    language model's own vocab_size aside: the OCR model's token head
    replaces its)."""
    for key, want in decoder.items():
        if key != "vocab_size" and hasattr(port_decoder, key):
            got = getattr(port_decoder, key)
            if (list(got) if isinstance(got, tuple) else got) != want:
                raise RuntimeError(f"the program's decoder {key} is {got}, the configuration's {want}")
