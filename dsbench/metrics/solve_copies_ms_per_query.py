"""Seconds of the engines' ``solve.copies`` stage
(``EngineMetrics.stage_seconds``, summed over the front end's engine and every
replica; each sweep's pass over the copy inequalities of OPTIONAL, inside
``solve.sweeps``) over the window and its tail, in ms per answered request;
nothing where the program has no such stage.  On a card the span times the
pass's dispatch and any wait inside it, not its kernels' device time."""


def read(run):
    n = len(run.answered)
    s = run.stages.get("solve.copies")
    return s * 1e3 / n if n and s is not None else None
