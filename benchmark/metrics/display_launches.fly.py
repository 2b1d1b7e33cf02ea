"""display_launches.fly: device operations (kernels and copies) launched
inside a display call, mean over the traced frames' display calls."""

import numpy as np


def read(rec):
    dt = rec["device_trace"]
    if not dt or not dt["launches"]["display"]:
        return None
    return float(np.mean(dt["launches"]["display"]))
