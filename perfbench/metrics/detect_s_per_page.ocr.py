"""Host seconds a page in the program's detection stage (``recognition.detect``)."""


def read(run):
    s = run.stage_s("recognition.detect")
    return s / run.stage_pages if s is not None and run.stage_pages else None
