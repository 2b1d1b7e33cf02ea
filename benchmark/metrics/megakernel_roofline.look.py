"""megakernel_roofline.look: the least time the chip could take for one
megakernel launch over its measured device time, in percent, counted as
``megakernel_roofline.converge`` counts it (``roofline.py``: the
reference's path segments of the checked launches times the
configuration's operations per segment, or the reference's tables and the
image; no walk's box, page or node test): in the heightfield cell the
streamed kernel's share of its roofline."""

from benchmark import spec

read = spec.reader("megakernel_roofline.converge")
