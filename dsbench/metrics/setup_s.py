"""Set-up: from the process's start (imports, corpus and requests, the
database, the server, every warm plan and the kernels' first build) to the
window's start, on the host clock."""


def read(run):
    return run.setup_s
