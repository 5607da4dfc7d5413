"""grad_step_s: the window's time over the train steps it completed."""


def read(run):
    w = run.window
    if "steps" not in w:
        return None
    return w["seconds"] / w["steps"]
