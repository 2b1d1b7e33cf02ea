"""render_host_ms.converge: host ms of the render call inside the program
(its ``crt.update`` span: ``RenderLayer.on_update``, the camera pack and
copy and the megakernel's launch, not synchronised), mean over the
window's frames."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "crt.update")
