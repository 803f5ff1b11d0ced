"""The port's detection stats path (component stats on the device, box
arithmetic on the host) against its host path and against the JAX
package's stats path, on the CPU in float32, on shared weights, with the
blob hook on both detectors (random weights find no lines): synthetic
pages, a tall page with a line on a chunk seam, a rotated page, mixed chunk
counts in one batch, a component overflow that reroutes its batch through
the maps path, and the one-channel ship.

The stats path labels at head resolution (1/4) and the host path the
upsampled map, so boxes are held by the IoU rule of
tests/test_device_postprocess.py: box counts within ``max_extra`` and every
host box but ``max_extra`` matched by a box of IoU >= ``min_iou``."""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)


def _bbox_iou(a, b):
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua else 0.0


def _compare(host_res, dev_res, min_iou=0.8, max_extra=1):
    h_boxes = [b.bbox for b in host_res.bboxes]
    d_boxes = [b.bbox for b in dev_res.bboxes]
    assert abs(len(h_boxes) - len(d_boxes)) <= max_extra, (len(h_boxes), len(d_boxes))
    matched = sum(max((_bbox_iou(hb, db) for db in d_boxes), default=0.0) >= min_iou for hb in h_boxes)
    assert matched >= len(h_boxes) - max_extra, (matched, len(h_boxes))


@pytest.fixture(scope="module")
def detectors():
    ref = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    jax_evit.install_blob_detector(ref)
    ours = DetectionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, ref.params))
    efficientvit.install_blob_detector(ours)
    return ref, ours


@contextlib.contextmanager
def _paths(stats: bool, resize: bool, s=settings):
    old = (s.DETECTOR_ON_DEVICE_POSTPROCESS, s.DETECTOR_DEVICE_RESIZE)
    s.DETECTOR_ON_DEVICE_POSTPROCESS, s.DETECTOR_DEVICE_RESIZE = stats, resize
    try:
        yield
    finally:
        s.DETECTOR_ON_DEVICE_POSTPROCESS, s.DETECTOR_DEVICE_RESIZE = old


def _run(det, images, stats: bool, resize: bool = True):
    """Detection with the stats path on or off; returns (results, stats
    batches, maps batches) of this call."""
    before = (det.stats_batches, det.maps_batches)
    with _paths(stats, resize):
        res = det([p.copy() for p in images])
    return res, det.stats_batches - before[0], det.maps_batches - before[1]


def _page(lines=8, width=1000, height=800, rotate=0.0):
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    for i in range(lines):
        draw.text((60, 40 + i * 80), f"Line {i}: some benchmark text here.", fill="black", font_size=28)
    if rotate:
        img = img.rotate(rotate, expand=False, fillcolor="white")
    return img


@pytest.mark.parametrize("resize", [False, True])
def test_axis_aligned_pages_match_host_path(detectors, resize):
    pages = [_page(), _page(lines=5, width=700, height=600)]
    host, _, _ = _run(detectors[1], pages, stats=False, resize=resize)
    dev, n_stats, n_maps = _run(detectors[1], pages, stats=True, resize=resize)
    assert (n_stats, n_maps) == (1, 0)
    for h, d in zip(host, dev):
        assert len(h.bboxes) > 0
        _compare(h, d)


def test_stats_path_matches_jax(detectors):
    """Device resize and stats on both sides: the port's boxes against the
    JAX package's, page by page, by the IoU rule with no box to spare."""
    ref, ours = detectors
    pages = [_page(), _page(lines=5, width=700, height=600), _page(rotate=3.0)]
    with _paths(True, True, jax_settings):
        expected = ref([p.copy() for p in pages])
    got, n_stats, _ = _run(ours, pages, stats=True)
    assert n_stats == 1
    for e, g in zip(expected, got):
        assert len(e.bboxes) > 0
        _compare(e, g, min_iou=0.95, max_extra=0)


def test_tall_page_merges_across_chunks(detectors):
    """A 2000 px page splits into chunks; a line across the 896 px seam comes
    back as one box on both paths."""
    img = Image.new("RGB", (900, 2000), "white")
    draw = ImageDraw.Draw(img)
    for y in (300, 893, 1500):
        draw.rectangle((100, y - 9, 800, y + 9), fill="black")
    [host], _, _ = _run(detectors[1], [img], stats=False)
    [dev], _, _ = _run(detectors[1], [img], stats=True)
    assert len(host.bboxes) == 3, [b.bbox for b in host.bboxes]
    assert len(dev.bboxes) == 3, [b.bbox for b in dev.bboxes]
    _compare(host, dev, max_extra=0)


def test_rotated_page(detectors):
    pages = [_page(rotate=3.0)]
    [host], _, _ = _run(detectors[1], pages, stats=False)
    [dev], _, _ = _run(detectors[1], pages, stats=True)
    assert len(host.bboxes) > 0
    _compare(host, dev, min_iou=0.6, max_extra=2)  # rotated quads come from the moments estimate


def test_component_overflow_reroutes_to_maps_path(detectors):
    """More components than DETECTOR_MAX_COMPONENTS: the batch goes through
    the maps path on the same device pixels (no box is dropped), counted in
    maps_batches; the next batch takes the stats path again."""
    det = detectors[1]
    pages = [_page(lines=6)]
    [host], _, _ = _run(det, pages, stats=False)
    old = settings.DETECTOR_MAX_COMPONENTS
    settings.DETECTOR_MAX_COMPONENTS = 3
    try:
        [dev], n_stats, n_maps = _run(det, pages, stats=True)
    finally:
        settings.DETECTOR_MAX_COMPONENTS = old
    assert (n_stats, n_maps) == (0, 1)
    assert len(dev.bboxes) == len(host.bboxes) > 3
    _compare(host, dev, max_extra=0)
    _, n_stats, n_maps = _run(det, pages, stats=True)
    assert (n_stats, n_maps) == (1, 0)


def test_mixed_chunk_counts_in_one_batch(detectors):
    """A 1-chunk page batched with a 3-chunk page: the padded page-map slots
    must not dilute the dynamic threshold."""
    short = Image.new("RGB", (900, 800), "white")
    tall = Image.new("RGB", (900, 2000), "white")
    ds, dt = ImageDraw.Draw(short), ImageDraw.Draw(tall)
    for y in range(60, 760, 120):
        ds.rectangle((80, y, 700, y + 16), fill="black")
    for y in range(60, 1950, 120):
        dt.rectangle((80, y, 700, y + 16), fill="black")
    host, _, _ = _run(detectors[1], [short, tall], stats=False)
    dev, n_stats, _ = _run(detectors[1], [short, tall], stats=True)
    assert n_stats == 1
    for h, d in zip(host, dev):
        assert len(h.bboxes) > 0
        _compare(h, d, max_extra=0)


def test_stats_program_error_raises(detectors, monkeypatch):
    """No quiet fallback: an error of the stats program reaches the caller."""
    det = detectors[1]

    def broken(*args, **kwargs):
        raise RuntimeError("stats program failed")

    monkeypatch.setattr(det, "_stats_program", broken)
    with pytest.raises(RuntimeError, match="stats program failed"):
        _run(det, [_page(lines=2)], stats=True)


@pytest.mark.parametrize("resize", [False, True])
def test_grayscale_ship_matches_rgb(detectors, resize):
    """One channel shipped for gray pages gives exactly the boxes of the
    three-channel ship; a colour page ships three channels."""
    det = detectors[1]
    pages = [_page(), _page(lines=5, width=700, height=600)]
    color = _page()
    ImageDraw.Draw(color).rectangle((100, 100, 300, 200), fill=(200, 40, 40))
    shipped = []
    upload = det._upload
    det._upload = lambda host: shipped.append(tuple(host.shape)) or upload(host)
    old = settings.DETECTOR_GRAYSCALE_SHIP
    try:
        settings.DETECTOR_GRAYSCALE_SHIP = None  # auto: gray content ships one channel
        gray_res, _, _ = _run(det, pages, stats=True, resize=resize)
        color_res, _, _ = _run(det, [color], stats=True, resize=resize)
        settings.DETECTOR_GRAYSCALE_SHIP = False
        rgb_res, _, _ = _run(det, pages, stats=True, resize=resize)
    finally:
        settings.DETECTOR_GRAYSCALE_SHIP = old
        del det._upload
    channels = [s[-1] for s in shipped if len(s) == 4]
    assert channels == [1, 3, 3]
    for g, r in zip(gray_res, rgb_res):
        assert len(g.bboxes) > 0
        assert [b.bbox for b in g.bboxes] == [b.bbox for b in r.bboxes]
    assert len(color_res[0].bboxes) > 0
