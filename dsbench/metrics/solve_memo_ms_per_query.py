"""Seconds of the engines' ``solve.memo`` stage
(``EngineMetrics.stage_seconds``, summed over the front end's engine and every
replica; each solve's chi packed on the host for the warm-start memo) over the
window and its tail, in ms per answered request; nothing where the program has
no such stage."""


def read(run):
    n = len(run.answered)
    s = run.stages.get("solve.memo")
    return s * 1e3 / n if n and s is not None else None
