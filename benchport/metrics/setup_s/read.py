"""setup_s: from the process's start to the end of the warm-up: imports,
the kernels loaded (built on a checkout's first run), the inputs made from
the seed, one warm-up of the cell's own path (host clock)."""


def read(run):
    return run.setup_s
