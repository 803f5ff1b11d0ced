"""Percent of the window's wall in which the card ran nothing: one minus
the device's busy time a page (the union of kernel, copy and memset
intervals in the traced calls, which a profiler slows on the host but not
on the card) times the window's pages, over the window's wall, which no
profiler slows."""


def read(run):
    if run.trace is None or not run.traced_pages or not run.stage_pages or not run.untraced_wall_s:
        return None
    busy = run.trace.busy_s / run.traced_pages * run.stage_pages
    return 100.0 * (1.0 - busy / run.untraced_wall_s)
