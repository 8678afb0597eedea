"""Seconds of the engines' ``plan`` stage (``EngineMetrics.stage_seconds``,
summed over the front end's engine and every replica) over the window and
its tail, in ms per answered request."""


def read(run):
    n = len(run.answered)
    return run.stages.get("plan", 0.0) * 1e3 / n if n else None
