"""pack_lights_ms.edit: host ms of the light table inside the program (its
``crt.pack_lights`` span: ``tables.nee_inputs``, the table packed and
uploaded), mean over the window's edits."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "crt.pack_lights")
