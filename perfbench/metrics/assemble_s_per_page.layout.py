"""Host seconds a page assembling layout's boxes and joining the tiles
(``layout.assemble``)."""


def read(run):
    s = run.stage_s("layout.assemble")
    return s / run.stage_pages if s is not None and run.stage_pages else None
