"""pack_tables_ms.edit: host ms of the table packing and upload inside the
program (its ``crt.pack_tables`` span: ``tables.kernel_inputs``), mean over
the window's edits."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "crt.pack_tables")
