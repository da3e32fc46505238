"""Host time a tick outside the step windows: (window wall - the
scheduler's summed step windows, ``MeshSlotScheduler.wall_s``) over the
window's ticks."""


def read(run):
    w = run.window
    return (w["wall_s"] - w["step_s"]) / w["ticks"] * 1e3
