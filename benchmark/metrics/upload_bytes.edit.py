"""upload_bytes.edit: bytes the program copies from the host to the device
in a rebuild (its counter ``upload_bytes``, as it counted inside each
``crt.sync_scene`` span: the scene arrays, the packed tables, the image
atlas and the light table), mean over the window's edits."""

from benchmark import program_spans


def read(rec):
    return program_spans.bytes_per_span(rec, "crt.sync_scene")
