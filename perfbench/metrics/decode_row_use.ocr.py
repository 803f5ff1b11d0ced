"""Percent of the decode chunks' row steps that give a kept token: the
counters ``recognition.decode_tokens_kept`` over
``recognition.decode_row_steps`` (every slot a chunk computes times the
steps it ran)."""


def read(run):
    kept = run.stages.get("recognition.decode_tokens_kept", {}).get("count")
    computed = run.stages.get("recognition.decode_row_steps", {}).get("count")
    return 100.0 * kept / computed if kept is not None and computed else None
