"""Native (C++) host components of the port.

Byte-for-byte copies of the JAX package's ``bvh_builder.cpp`` (the
binned-SAH BVH builder) and ``table_packer.cpp`` (the megakernel's table
packer), compiled with ``g++`` into one shared library at first use
(``build.py``) and bound with ctypes (``bvh_native``, ``pack_native``).
A build that fails, or a library of another table layout, raises: the
port has no silent NumPy fallback.
"""
