"""edit_ms_p95: the 95th percentile over every edit of the window of the
host time from the ``Scene.update`` call to that edit's first RGBA8 on the
host (the edit traffic moves the scene before every frame).  Host
clock."""

import numpy as np


def read(rec):
    return float(np.percentile(rec["frame_ms"], 95))
