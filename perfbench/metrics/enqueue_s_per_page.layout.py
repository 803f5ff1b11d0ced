"""Host seconds a page enqueuing layout's dispatches (``last_run["enqueue_s"]``)."""


def read(run):
    s = run.counters.get("enqueue_s")
    return s / run.stage_pages if s is not None and run.stage_pages else None
