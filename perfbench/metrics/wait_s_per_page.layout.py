"""Host seconds a page layout waits on the card for a dispatch's outputs
(``layout.wait``)."""


def read(run):
    s = run.stage_s("layout.wait")
    return s / run.stage_pages if s is not None and run.stage_pages else None
