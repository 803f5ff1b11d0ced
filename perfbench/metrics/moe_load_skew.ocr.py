"""How unevenly the router loads the experts: the rows of the most loaded
expert, summed over the sparse layers' calls (the counter
``recognition.moe_rows_max``), times the number of experts, over every
token-expert row (``recognition.moe_rows``), over the window's calls; 1.0
where every expert takes the same rows."""


def read(run):
    largest = run.stages.get("recognition.moe_rows_max", {}).get("count")
    rows = run.stages.get("recognition.moe_rows", {}).get("count")
    experts = run.work.get("moe_experts")
    return largest * experts / rows if largest is not None and rows and experts else None
