"""frame_ms_p95: the 95th percentile over every frame of the window of the
host time from the frame's start (before its input) to its RGBA8 on the
host.  Host clock."""

import numpy as np


def read(rec):
    return float(np.percentile(rec["frame_ms"], 95))
