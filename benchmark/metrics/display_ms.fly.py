"""display_ms.fly: host ms of the synced display call under ``denoise``
(the G-buffer pass when the camera moved, the a-trous denoiser, tonemap
and the RGBA8 copy to the host), mean over the traced window's frames."""

from benchmark import devtrace


def read(rec):
    return devtrace.mean_span(rec, "display")
