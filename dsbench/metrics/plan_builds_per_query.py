"""Plans built from scratch (``EngineMetrics.plan_builds``, summed over the
front end's engine and every replica) over the window and its tail, per
answered request."""


def read(run):
    n = len(run.answered)
    return run.plan_builds / n if n else None
