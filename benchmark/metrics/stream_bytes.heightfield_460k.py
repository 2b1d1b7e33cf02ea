"""stream_bytes.heightfield_460k: bytes of the streamed tables on the
device (the tiles, the block, cluster and supercluster tables, the column
map and the group boxes), the port's counter ``route.stream_bytes`` set
where ``ops/cuda/tables.py::kernel_inputs`` chooses the layout.  None
where the latest table build stayed resident (``route.streamed`` 0) or
the program keeps no such counter."""


def read(rec):
    try:
        from cudaraytracer_tpu_torch.utils import trace
    except ImportError:
        return None
    counters = trace.RECORDER.read_counters()
    if not counters.get("route.streamed"):
        return None
    return counters.get("route.stream_bytes")
