"""megakernel_roofline.converge: the least time the chip could take for one
megakernel launch (``roofline.py``: its path segments times the
configuration's operations per segment at 67 TFLOP/s, or its tables and
image at 3.35 TB/s, whichever is longer) over the measured device time per
launch, in percent."""

from benchmark import devtrace, roofline


def read(rec):
    k = devtrace.kernel_stats(rec["device_trace"], "render_kernel")
    ref = rec["reference"]
    if k is None or not ref["lanes"]:
        return None
    seg = ref["tally"].get("segments", 0) / ref["lanes"]
    ops = roofline.launch_ops(seg, rec["width"], rec["height"],
                              rec["config"]["ops_per_segment"])
    nbytes = roofline.launch_bytes(ref["table_bytes"], rec["width"],
                                   rec["height"])
    return 100.0 * roofline.bound_seconds(ops, nbytes) / (k[1] / k[0])
