"""Percent of the prefill waves' patch rows that hold a prompt's patch: the
counters ``recognition.wave_patches`` over ``recognition.wave_patch_cap``."""


def read(run):
    used = run.stages.get("recognition.wave_patches", {}).get("count")
    cap = run.stages.get("recognition.wave_patch_cap", {}).get("count")
    return 100.0 * used / cap if used is not None and cap else None
