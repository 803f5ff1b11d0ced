"""OCR's result assembly of the port against the JAX package's, on the CPU
with no model: the same token ids, scores, box-head outputs and line
polygons through both predictors' ``_assemble_results``, each on a minimal
stand-in ``self`` (tokenizer, config, tasks), must give results whose
``model_dump()`` are equal with ``==``; the port's counters must count
the characters of the results and the runs it decoded; and the hold on the
garbage collector that assembly takes must leave it as it was."""

import gc
import math
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.recognition.tokenizer import OCRTokenizer as JaxOCRTokenizer
from surya_tpu_torch.common import profiling
from surya_tpu_torch.recognition import RecognitionPredictor, _collector_paused
from surya_tpu_torch.recognition.tokenizer import DEFAULT_SPECIAL_TOKENS, NOMATH_TOKEN, OCRTokenizer

BBOX_SIZE = 1025
SCRIPT_TAG = "<SCRIPT-Latin>"
# the default tags and one script tag, which assembly skips like NOMATH
SPECIAL_TOKENS = {**DEFAULT_SPECIAL_TOKENS, "system": DEFAULT_SPECIAL_TOKENS["system"] + [SCRIPT_TAG],
                  "all": DEFAULT_SPECIAL_TOKENS["all"] + [SCRIPT_TAG]}
TOK = OCRTokenizer(SPECIAL_TOKENS)


def _stand_in(cls, tokenizer):
    class StandIn:
        tasks = cls.tasks
        get_bboxes_text = cls.get_bboxes_text
        _assemble_results = cls._assemble_results

    self = StandIn()
    st = tokenizer.system_tokens
    self.processor = SimpleNamespace(tokenizer=tokenizer, no_output_token=st["<NOP>"])
    self.config = SimpleNamespace(eos_token_id=st["</S>"], pad_token_id=st["<PAD>"], bbox_size=BBOX_SIZE)
    return self


PORT = _stand_in(RecognitionPredictor, TOK)
JAX = _stand_in(JaxRecognitionPredictor, JaxOCRTokenizer(SPECIAL_TOKENS))


# -- token ids -------------------------------------------------------------------


def utf16(text):
    return [TOK.special_token_offset + u for u in TOK.text_to_utf16_numbers(text)]


def units(*codes):
    """Raw UTF-16 code units, lone surrogates included."""
    return [TOK.special_token_offset + c for c in codes]


def tag(name):
    return [TOK.SPECIAL_TOKEN_MAPPING[name]]


def qwen(text):
    return TOK.math_tokenizer.encode(text)


EOS, PAD, NOP = tag("</S>")[0], tag("<PAD>")[0], tag("<NOP>")[0]


# -- a call's inputs ---------------------------------------------------------------


class Line:
    def __init__(self, tokens, width=None, height=None, box=None, res_scale=(1, 1), dup=(), nan=(), head=None):
        """tokens: the line's ids; width x height: its slice (random where
        None); box: its page polygon (a random quad where None); dup: (t,
        dx) pairs, token t's box is token t - 1's moved dx (bbox units) in x;
        nan: positions of NaN scores; head: the box head's first rows
        (cx, cy, w, h, xskew, yskew), random where None."""
        self.tokens, self.width, self.height, self.box = tokens, width, height, box
        self.res_scale, self.dup, self.nan, self.head = res_scale, dup, nan, head


def make_call(rng, pages, page_size=(1240, 1754)):
    """(images, flat, tokens, scores, bbox_arr) of one call: pages is a list
    of pages, each a list of Line."""
    lines = [ln for page in pages for ln in page]
    width = max([len(ln.tokens) for ln in lines], default=1)
    bbox_arr = np.zeros((len(lines), max(width, 1), 6), np.float32)
    slices, polygons, tokens, scores = [], [], [], []
    for i, ln in enumerate(lines):
        w = ln.width or int(rng.integers(60, 1200))
        h = ln.height or int(rng.integers(16, 90))
        slices.append(np.broadcast_to(np.uint8(0), (h, w, 3)))
        if ln.box is None:
            x0, y0 = rng.uniform(-5, page_size[0] - w), rng.uniform(-5, page_size[1] - h)
            jit = rng.uniform(-4, 4, (4, 2))
            quad = np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]]) + jit
            polygons.append(quad.tolist() if i % 2 else np.round(quad).astype(int).tolist())
        else:
            polygons.append(ln.box)
        n = len(ln.tokens)
        # cx, cy, w, h in bbox units, partly out of the slice; skews around the scaler
        bbox_arr[i, :n, 0] = rng.uniform(-30, BBOX_SIZE + 30, n)
        bbox_arr[i, :n, 1] = rng.uniform(200, 800, n)
        bbox_arr[i, :n, 2] = rng.uniform(1, 80, n)
        bbox_arr[i, :n, 3] = rng.uniform(300, 1200, n)
        bbox_arr[i, :n, 4:] = rng.uniform(BBOX_SIZE // 2 - 12, BBOX_SIZE // 2 + 12, (n, 2))
        if ln.head is not None:
            bbox_arr[i, : len(ln.head)] = ln.head
        for t, dx in ln.dup:
            bbox_arr[i, t] = bbox_arr[i, t - 1]
            bbox_arr[i, t, 0] += dx
        s = rng.uniform(0, 1, n)
        s[list(ln.nan)] = np.nan
        scores.append(s.tolist())
        tokens.append(list(ln.tokens))
    flat = {
        "slices": slices,
        "slice_map": [len(page) for page in pages],
        "polygons": polygons,
        "task_names": ["ocr_with_boxes"] * len(lines),
        "input_text": [None] * len(lines),
        "res_scales": [ln.res_scale for ln in lines],
    }
    images = [SimpleNamespace(size=page_size) for _ in pages]
    return images, flat, tokens, scores, bbox_arr


def _text_line(rng, n=40):
    """A line of n UTF-16 tokens of one repeated character, as random
    weights decode."""
    return Line(utf16(chr(int(rng.integers(0x21, 0xD7FF)))) * n)


# -- the cases -----------------------------------------------------------------------


def _surrogates(rng):
    return [[
        Line(utf16("a\U0001D518b\U0001D519 c")),  # surrogate pairs: fewer characters than boxes
        Line(units(0xD800)),  # a lone surrogate: empty text
        Line(units(0xDC00, 0xD801)),
        Line(units(0x61, 0xD800, 0x62) + utf16("\U0001F600")),
    ]]


def _qwen(rng):
    return [[
        Line(tag("<math>") + qwen("x^2+y") + tag("</math>") + utf16(" ok")),
        Line(qwen("\\frac{a}{b}")),
        Line(utf16("ab") + qwen("cd") + utf16("ef") + qwen("")),
    ]]


def _special(rng):
    return [[
        Line(tag(NOMATH_TOKEN) + utf16("plain") + tag(SCRIPT_TAG) + utf16("x")),
        Line(tag("<b>") + utf16("bold") + tag("</b>") + tag("<br>") + tag("<i>") + tag("</i>")),
        Line(tag(SCRIPT_TAG) + tag(NOMATH_TOKEN)),  # every run skipped: an empty line
    ]]


def _unbalanced(rng):
    return [[
        Line(tag("<b>") + utf16("open bold")),
        Line(utf16("close ") + tag("</i>") + tag("<u>") + utf16("u")),
        Line(tag("<math>") + qwen("a+b")),
    ]]


def _eos_pad(rng):
    return [[
        Line(utf16("before") + [EOS] + utf16("after")),
        Line(utf16("pad") + [PAD, PAD] + utf16("x")),
        Line([EOS] + utf16("nothing")),
        Line(tag("<b>") + [PAD] + qwen("q")),
    ]]


def _no_output(rng):
    return [[Line([NOP]), Line(utf16("text") + [NOP] + utf16("more")), Line(utf16("kept"))]]


def _nan_scores(rng):
    return [[
        Line(utf16("nan scores here"), nan=(0, 3, 14)),
        Line(tag("<b>") + utf16("b") + qwen("q"), nan=(0, 2)),
        Line(utf16("all"), nan=(0, 1, 2)),
    ]]


def _near_duplicates(rng):
    # slice width BBOX_SIZE: one bbox unit is one pixel of x
    d = [(1, 0.0), (2, 0.05), (3, 0.1), (4, 0.15), (5, 0.099), (6, 0.101), (8, -0.05), (9, -0.2)]
    return [[
        Line(utf16("abcdefghijkl"), width=BBOX_SIZE, dup=d),
        Line(utf16("ab") + tag("<b>") + utf16("cdefgh"), width=BBOX_SIZE, dup=[(1, 0.0), (3, 0.0), (4, 0.0)]),
    ]]


def _chars_vs_polygons(rng):
    return [[
        # more characters than kept polygons: every box a duplicate of the first
        Line(utf16("many chars one box"), dup=[(t, 0.0) for t in range(1, 18)]),
        # fewer: each character two tokens
        Line(utf16("\U0001D400\U0001D401\U0001D402")),
        Line(utf16("x\U0001D400y"), dup=[(1, 0.0), (2, 0.0), (3, 0.0)]),
    ]]


def _res_scales(rng):
    return [[
        Line(utf16("highres slice"), res_scale=(1.7, 2.3)),
        Line(utf16("lower") + tag("<b>"), res_scale=(0.5, 0.8)),
        Line(utf16("odd"), res_scale=(1.3333333333333333, 3.0)),
        # whole-pixel corners (x 33, 67; y 39, 65, at a slice of BBOX_SIZE
        # square) where x * (1 / 1.1) truncates below x / 1.1, and y with 1.3
        Line(utf16("edge"), width=BBOX_SIZE, height=BBOX_SIZE, res_scale=(1.1, 1.3),
             head=[[50, 52, 34, 26, BBOX_SIZE // 2, BBOX_SIZE // 2]] * 4),
    ]]


def _negative_zero_box(rng):
    # corners at -0.2 truncate to zero, shifted by a line box at -0.0
    box = [[-0.0, -0.0], [300.0, -0.0], [300.0, 40.0], [-0.0, 40.0]]
    head = [[0.3, 0.3, 1.0, 1.0, BBOX_SIZE // 2, BBOX_SIZE // 2]] * 3
    # and a box of no width at -0.0, whose upper bound holds 0.0 where it is
    flat_box = [[-0.0, 5.0], [-0.0, 5.0], [-0.0, 40.0], [-0.0, 40.0]]
    return [[Line(utf16("abc"), width=BBOX_SIZE, height=BBOX_SIZE, box=box, head=head),
             Line(tag("<b>") + utf16("z"), box=box),
             Line(utf16("abc"), width=BBOX_SIZE, height=BBOX_SIZE, box=flat_box, head=head)]]


def _drop_repeated(rng):
    return [[
        Line(utf16("ab") * 25),  # a repeated tail: one blank character
        Line(utf16("no repeat here")),
        Line(utf16("abc") * 15 + [NOP]),
    ]]


def _mixed(rng):
    """Random lines over every kind of id."""
    pools = [qwen("abc+=^"), tag("<b>") + tag("</b>") + tag("<i>") + tag(NOMATH_TOKEN) + tag(SCRIPT_TAG),
             utf16("the quick brown fox \U0001D518"), units(0xD800, 0xDFFF), [EOS, PAD]]
    pages = []
    for _ in range(3):
        page = []
        for _ in range(int(rng.integers(0, 6))):
            n = int(rng.integers(1, 30))
            kinds = rng.choice(len(pools), n, p=[0.15, 0.15, 0.6, 0.07, 0.03])
            toks = [int(rng.choice(pools[k])) for k in kinds]
            page.append(Line(toks, nan=tuple(rng.choice(n, int(rng.integers(0, 3))).tolist()),
                             dup=[(t, float(rng.choice([0.0, 0.05, 0.2]))) for t in range(1, n) if rng.random() < 0.3],
                             res_scale=(1, 1) if rng.random() < 0.5 else (1.5, 1.25)))
        pages.append(page)
    return pages


def _empty_pages(rng):
    return [[], [Line(utf16("only line"))], []]


def _no_lines(rng):
    return [[], []]


def _one_page(rng):
    # stream() assembles each finished page in a call of its own
    return [[_text_line(rng), Line(utf16("second"))]]


def _benchmark(rng):
    # 16 pages of 40 lines of 40 tokens, as a whole-page OCR call
    return [[_text_line(rng) for _ in range(40)] for _ in range(16)]


CASES = {
    "surrogates": (_surrogates, {}),
    "qwen": (_qwen, {}),
    "special": (_special, {}),
    "unbalanced_tags": (_unbalanced, {}),
    "eos_pad_mid_line": (_eos_pad, {}),
    "no_output_token": (_no_output, {}),
    "nan_scores": (_nan_scores, {}),
    "near_duplicate_polygons": (_near_duplicates, {}),
    "chars_vs_polygons": (_chars_vs_polygons, {}),
    "res_scales": (_res_scales, {}),
    "negative_zero_line_box": (_negative_zero_box, {}),
    "drop_repeated_text": (_drop_repeated, {"drop_repeated_text": True}),
    "return_words": (_mixed, {"return_words": True}),
    "sort_lines": (_mixed, {"sort_lines": True}),
    "mixed_all_options": (_mixed, {"sort_lines": True, "return_words": True, "drop_repeated_text": True}),
    "page_without_lines": (_empty_pages, {"return_words": True}),
    "no_lines": (_no_lines, {}),
    "one_page_stream_call": (_one_page, {}),
    "benchmark_call": (_benchmark, {}),
}


def _dump(results):
    return [r.model_dump() for r in results]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_assembly_equals_the_jax_packages(case, seed):
    build, kw = CASES[case]
    images, flat, tokens, scores, bbox_arr = make_call(np.random.default_rng(seed), build(np.random.default_rng(seed)))
    want = JAX._assemble_results(images, flat, [list(t) for t in tokens], [list(s) for s in scores], bbox_arr, **kw)
    got = PORT._assemble_results(images, flat, tokens, scores, bbox_arr, **kw)
    assert _dump(got) == _dump(want)
    assert [r.model_dump_json() for r in got] == [r.model_dump_json() for r in want]
    for g, w in zip(got, want):
        for gl, wl in zip(g.text_lines, w.text_lines):
            assert gl.model_fields_set == wl.model_fields_set
            assert [c.model_fields_set for c in gl.chars] == [c.model_fields_set for c in wl.chars]
            assert [c.__getstate__() for c in gl.chars] == [c.__getstate__() for c in wl.chars]
            assert all(isinstance(v, float) for c in gl.chars for pt in c.polygon for v in pt)
            assert all(isinstance(c.confidence, float) and not math.isnan(c.confidence) for c in gl.chars)


def test_counters_count_chars_and_runs():
    """A 16-page call of lines of one to four runs: assemble_chars is the
    characters of the results, assemble_runs the runs decoded."""
    rng = np.random.default_rng(5)
    shapes = [
        (utf16("plain text"), 1),
        (utf16("ab") + tag("<b>") + utf16("cd") + tag("</b>"), 4),
        (tag("<math>") + qwen("x+1") + tag("</math>"), 3),
        (units(0xD800), 1),  # decoded, to nothing
        ([NOP], 0),
    ]
    pages, runs = [], 0
    for _ in range(16):
        page = []
        for _ in range(10):
            toks, n = shapes[int(rng.integers(len(shapes)))]
            page.append(Line(toks))
            runs += n
        pages.append(page)
    images, flat, tokens, scores, bbox_arr = make_call(rng, pages)
    profiling.report()
    results = PORT._assemble_results(images, flat, tokens, scores, bbox_arr)
    got = profiling.report()
    assert got["recognition.assemble_chars"] == {
        "count": sum(len(line.chars) for r in results for line in r.text_lines), "calls": 1}
    assert got["recognition.assemble_runs"] == {"count": runs, "calls": 1}
    assert got["recognition.assemble"]["calls"] == got["recognition.detokenize"]["calls"] == 1


def test_collector_holds_nest_across_threads():
    """Holds taken and let go by many threads at once: the collector is off
    inside every hold and back on after the last; one taken while it was
    off leaves it off."""
    assert gc.isenabled()
    seen_on = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(300):
                with _collector_paused():
                    time.sleep(0)  # let another thread in while this one holds
                    seen_on.append(gc.isenabled())

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(seen_on) == 16 * 300 and not any(seen_on)
    assert gc.isenabled()
    gc.disable()
    try:
        with _collector_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
