"""Host seconds a page detokenizing and assembling OCR's results
(``recognition.assemble``)."""


def read(run):
    s = run.stage_s("recognition.assemble")
    return s / run.stage_pages if s is not None and run.stage_pages else None
