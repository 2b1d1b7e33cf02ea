"""megakernel_ms.look: device ms per megakernel launch (``render_kernel*``
in the device trace of the traced frames: whichever entry the table route
takes, in the heightfield cell the streamed one), read as
``megakernel_ms.converge`` reads it."""

from benchmark import spec

read = spec.reader("megakernel_ms.converge")
