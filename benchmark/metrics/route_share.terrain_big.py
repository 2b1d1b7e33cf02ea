"""route_share.terrain_big: the resident tables' bytes over the card's
streaming budget, in percent, as the port's latest table build counted
them (its counters ``route.table_bytes`` and ``route.budget_bytes``, set
where ``ops/cuda/tables.py::kernel_inputs`` chooses the layout).  Near
100 the tables are about to take the streamed layout; a change that grows
them shows here before the route flips.  None where the program keeps no
such counters, or built its tables without a budget."""


def read(rec):
    try:
        from cudaraytracer_tpu_torch.utils import trace
    except ImportError:
        return None
    counters = trace.RECORDER.read_counters()
    nbytes = counters.get("route.table_bytes")
    budget = counters.get("route.budget_bytes")
    if nbytes is None or not budget:
        return None
    return 100.0 * nbytes / budget
