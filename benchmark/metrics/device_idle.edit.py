"""device_idle.edit: the share of the traced frames' window in which no
operation ran on the device, in percent (``devtrace.reduce``)."""

from benchmark import devtrace


def read(rec):
    return devtrace.idle_percent(rec["device_trace"])
