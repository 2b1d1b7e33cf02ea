"""Image I/O helpers.

Analog of the reference's stb usage (reference: CudaRayTracer/src/Utils/
RawStbImage.h:12-22 for loading; the reference cannot save renders at all —
offline PNG output is an improvement).  PIL-backed with a raw-PPM fallback.
"""

from __future__ import annotations

import numpy as np


def save_png(path: str, image: np.ndarray, flip_vertical: bool = True):
    """Save an RGB(A) uint8 or float [0,1] image.

    ``flip_vertical`` converts framebuffer order (row 0 = bottom, the
    reference's GL convention — it flips at display time with uv coords,
    CudaLayer.cpp:402) to standard image order.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if flip_vertical:
        arr = arr[::-1]
    try:
        from PIL import Image

        mode = "RGBA" if arr.shape[-1] == 4 else "RGB"
        Image.fromarray(arr, mode).save(path)
    except ImportError:  # raw PPM fallback (RGB only)
        rgb = arr[..., :3]
        with open(path.rsplit(".", 1)[0] + ".ppm", "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
            f.write(rgb.tobytes())


def save_pfm(path, radiance: np.ndarray):
    """Save LINEAR float radiance as a color PFM (portable float map) —
    the HDR export for compositing pipelines.  PFM rows are stored
    bottom-up by spec, so a display-oriented (row 0 = top) input is
    flipped on write; scale -1.0 = little-endian float32.  ``path`` is a
    filesystem path or a binary file-like (the viewer's /radiance.pfm)."""
    arr = np.asarray(radiance, np.float32)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected HxWx3 radiance, got {arr.shape}")
    f = path if hasattr(path, "write") else open(path, "wb")
    try:
        f.write(b"PF\n%d %d\n-1.0\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr[::-1].astype("<f4").tobytes())
    finally:
        if f is not path:
            f.close()


def load_pfm(path: str) -> np.ndarray:
    """Read a color PFM back to display-oriented f32[H,W,3]."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"PF":
            raise ValueError("not a color PFM")
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(w * h * 12),
                             "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1].astype(np.float32)
