"""Host seconds a page the scheduler is busy: ``recognition.loop`` less the
caller's waits nested in it (``recognition.drain_prefill``,
``.drain_decode``, ``.feed`` and ``.build_wait``)."""


def read(run):
    loop = run.stage_s("recognition.loop")
    if loop is None or not run.stage_pages:
        return None
    waits = run.stage_s("recognition.drain_prefill", "recognition.drain_decode", "recognition.feed",
                        "recognition.build_wait")
    return (loop - (waits or 0.0)) / run.stage_pages
