"""display_ms.converge: host ms of the synced display call
(``RenderLayer.framebuffer_rgba8``: tonemap and the RGBA8 copy to the
host), mean over the traced window's frames."""

from benchmark import devtrace


def read(rec):
    return devtrace.mean_span(rec, "display")
