"""Seconds of the engines' ``solve.bind`` stage
(``EngineMetrics.stage_seconds``, summed over the front end's engine and every
replica; each solve's constant rows built, packed and uploaded, with its warm
start) over the window and its tail, in ms per answered request; nothing where
the program has no such stage."""


def read(run):
    n = len(run.answered)
    s = run.stages.get("solve.bind")
    return s * 1e3 / n if n and s is not None else None
