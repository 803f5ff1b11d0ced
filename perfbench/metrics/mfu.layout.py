"""Percent of the card's bf16 peak that the model's FLOPs make of the
untraced calls' wall: the FLOPs a page of the traced calls needs
(perfbench/counts) times the pages served after them, over their wall."""

from perfbench import peaks


def read(run):
    if run.trace is None:  # no device was traced: not a run on the card
        return None
    flops = run.work.get("model_flops")
    if not flops or not run.traced_pages or not run.stage_pages or not run.untraced_wall_s:
        return None
    return 100.0 * flops / run.traced_pages * run.stage_pages / (run.untraced_wall_s * peaks.BF16_FLOPS_PER_S)
