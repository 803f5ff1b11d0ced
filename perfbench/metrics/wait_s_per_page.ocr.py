"""Host seconds a page the scheduler waits on the card for a dispatch's
outputs (``recognition.drain_prefill`` and ``recognition.drain_decode``)."""


def read(run):
    s = run.stage_s("recognition.drain_prefill", "recognition.drain_decode")
    return s / run.stage_pages if s is not None and run.stage_pages else None
