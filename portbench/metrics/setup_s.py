"""setup_s: seconds from the process's start to the window's (imports,
the kernel library's build or load, the scene build and commit, the
warm-up of the cell's shapes)."""


def read(run):
    return run.setup_s
