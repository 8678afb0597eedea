"""Seconds of the engines' ``plan.compile`` stage
(``EngineMetrics.stage_seconds``, summed over the front end's engine and every
replica; the plans built from scratch: SOI build, batch layout, SOI compile
against the graph and the engine's choice) over the window and its tail, in ms
per answered request; nothing where the program has no such stage."""


def read(run):
    n = len(run.answered)
    s = run.stages.get("plan.compile")
    return s * 1e3 / n if n and s is not None else None
