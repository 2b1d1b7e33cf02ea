"""msamples_per_s: millions of samples displayed per second: width x
height x samples per launch for every frame of the window, over the
window's seconds (first frame's start to last frame's RGBA8 on the
host).  Host clock."""


def read(rec):
    return (rec["frames"] * rec["width"] * rec["height"] * rec["spp"]
            / rec["window_s"] / 1e6)
