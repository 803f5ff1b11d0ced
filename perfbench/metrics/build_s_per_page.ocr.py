"""Host seconds a page slicing lines and building prefill waves
(``recognition.slice`` and ``recognition.prefill_build``)."""


def read(run):
    s = run.stage_s("recognition.slice", "recognition.prefill_build")
    return s / run.stage_pages if s is not None and run.stage_pages else None
