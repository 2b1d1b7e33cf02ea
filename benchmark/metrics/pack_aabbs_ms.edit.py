"""pack_aabbs_ms.edit: host ms of the primitives' boxes inside the program
(its ``crt.aabbs`` span: ``models/bvh.py::primitive_aabbs``, a loop over
the primitives in Python), mean over the window's edits."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "crt.aabbs")
