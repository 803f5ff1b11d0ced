"""Host seconds a page slicing, resizing and packing layout's tiles
(``layout.prepare``)."""


def read(run):
    s = run.stage_s("layout.prepare")
    return s / run.stage_pages if s is not None and run.stage_pages else None
