"""samples_per_s: every pixel sample of the renders the window completed,
over the window's whole time, in millions a second."""


def read(run):
    w = run.window
    if "samples" not in w:
        return None
    return w["samples"] / w["seconds"] / 1e6
