"""device_idle.look: the share of the traced frames' window in which no
operation ran on the device, in percent, read as ``device_idle.converge``
reads it (``devtrace.reduce``)."""

from benchmark import spec

read = spec.reader("device_idle.converge")
