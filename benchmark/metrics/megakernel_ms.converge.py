"""megakernel_ms.converge: device ms per megakernel launch
(``render_kernel*`` in the device trace of the traced frames)."""

from benchmark import devtrace


def read(rec):
    k = devtrace.kernel_stats(rec["device_trace"], "render_kernel")
    return None if k is None else k[1] / k[0] * 1e3
