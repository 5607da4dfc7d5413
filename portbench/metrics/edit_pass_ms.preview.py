"""edit_pass_ms.preview: the mean wall of the window's passes that follow
a material edit (the edit's table rebuild and its copy into the kept
program included)."""


def read(run):
    ms = run.window.get("edit_pass_ms")
    return sum(ms) / len(ms) if ms else None
