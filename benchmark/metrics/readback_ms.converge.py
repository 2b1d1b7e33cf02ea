"""readback_ms.converge: host ms of the display's RGBA8 copy to the host
inside the program (its ``crt.readback`` span: the wait for the display's
own device work and the 3.7 MB copy to pageable memory), mean over the
window's frames."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "crt.readback")
