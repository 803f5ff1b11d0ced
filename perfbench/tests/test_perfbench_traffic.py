import numpy as np

from perfbench import traffic


def small(mix):
    return dict(mix, page_pool=3)


def test_same_seed_same_pages():
    mix = small(traffic.load("pages40"))
    a, b = traffic.page_pool(mix, 2**31 + 5), traffic.page_pool(mix, 2**31 + 5)
    for p, q in zip(a, b):
        assert np.array_equal(np.asarray(p.image), np.asarray(q.image))
        assert p.lines == q.lines and p.texts == q.texts


def test_other_seed_other_glyphs_same_work():
    mix = small(traffic.load("pages40"))
    a, b = traffic.page_pool(mix, 7), traffic.page_pool(mix, 8)
    assert not np.array_equal(np.asarray(a[0].image), np.asarray(b[0].image))
    for p, q in zip(a, b):
        assert len(p.lines) == len(q.lines) == mix["page"]["lines"]
        assert [len(t) for t in p.texts] == [len(t) for t in q.texts]
        assert [len(mix["page"]["text"].format(i=i)) for i in range(len(p.texts))] == [len(t) for t in p.texts]


def test_ink_boxes_hold_the_ink():
    mix = small(traffic.load("lines40"))
    page = traffic.page_pool(mix, 3)[0]
    dark = np.asarray(page.image)[..., 0] < 128
    inside = np.zeros_like(dark)
    for x0, y0, x1, y1 in page.lines:
        assert x1 > x0 and y1 > y0
        inside[y0:y1, x0:x1] = True
    assert dark.any() and not (dark & ~inside).any()


def test_calls_cycle_the_pool():
    mix = dict(traffic.load("boxes40"), page_pool=4, pages_per_call=2)
    pool = list(range(4))
    assert [traffic.call_pages(mix, pool, k) for k in range(3)] == [[0, 1], [2, 3], [0, 1]]


def test_every_mix_names_its_call_and_tracing():
    for path in traffic.TRAFFIC_DIR.glob("*.json"):
        mix = traffic.load(path.stem)
        assert mix["call"] in ("whole_page", "given_lines", "layout")
        assert mix["trace_calls"] >= 1 and mix["pages_per_call"] >= 1
