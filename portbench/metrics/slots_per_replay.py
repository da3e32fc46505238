"""Real slots a graph replay in the window: slots over the scheduler's
steps (``n_steps``, one replay each on one device)."""


def read(run):
    w = run.window
    return w["slots"] / w["steps"] if w["steps"] else None
