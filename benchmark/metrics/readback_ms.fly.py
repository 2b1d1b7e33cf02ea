"""readback_ms.fly: host ms of the denoised display's RGBA8 copy to the
host inside the program (its ``crt.readback`` span: the wait for the
denoiser's queued device work and the copy), mean over the window's
frames."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "crt.readback")
