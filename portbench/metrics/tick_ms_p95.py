"""95th percentile of every tick's host wall in the window, from the
``tick()`` call to its return (which ends in the mesh's synchronize)."""
import numpy as np


def read(run):
    return float(np.percentile(run.window["tick_s"], 95)) * 1e3
