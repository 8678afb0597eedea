"""Device ms of the traced window's device-to-host copies (the profiler's
``Memcpy DtoH`` events: chi's copy back and the sweeps' convergence reads),
per answered request."""


def read(run):
    s = run.summary
    n = len(run.answered)
    if s is None or not n:
        return None
    t = sum(v for k, v in s.device_s.items() if k.startswith("Memcpy DtoH"))
    return t * 1e3 / n if t > 0.0 else None
