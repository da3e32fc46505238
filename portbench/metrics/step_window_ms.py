"""Mean step window in the window (``MeshSlotScheduler.wall_s`` over
``n_steps``): the staging copies, the replay, the next bucket's
staging and the synchronize."""


def read(run):
    w = run.window
    return w["step_s"] / w["steps"] * 1e3 if w["steps"] else None
