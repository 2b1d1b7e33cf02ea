"""Table-staging probe: wrapper and plain PyTorch version.

Port of ``tools/stream_probe.py``'s kernels (``_build`` :57 and
``_build_2d`` :119): over an i32[n_tiles, rows, tile_len] table, 32 reads
per tile i, read j at row (i*3 + j*5) % rows and column (i*7 + j*13) %
tile_len, summed with int32 wraparound (``expected``).  The variants
differ in how a tile reaches the reads (``variants_for``): ``resident``
reads it in place, ``stream`` (rows 1) and ``stream2d`` (rows > 1) stage
it into shared memory with one bulk async copy, ``streamrows`` (rows > 1)
with one copy per row onto one barrier.

* CUDA tensors launch ``csrc/stream_probe.cu``: one warp per CTA, one
  CTA per SM by default, each CTA walking every tile and storing its own
  sum.
* CPU tensors run ``stream_probe_plain``: the staging buffer as the reads
  find it after each tile's wait, then a gather of the same reads.

Both return i32[n_ctas], every entry the walk's sum, and count their
launches (``stream_probe.launches``, ``stream_probe_plain.launches``).
Invalid arguments raise ``ValueError`` before anything runs: the copies
move 16-byte multiples, so a staged variant needs tile_len % 4 == 0, and
a tile of at most 227 KB of shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

READS = 32
# csrc/stream_probe.cu's variant codes: in place, one copy per tile, one
# copy per row
_CODES = {"resident": 0, "stream": 1, "stream2d": 1, "streamrows": 2}
SMEM_MAX = 227 * 1024


def variants_for(rows: int) -> tuple:
    """The variants of a table with ``rows`` rows per tile, as
    tools/stream_probe.py runs them."""
    if rows == 1:
        return ("resident", "stream")
    return ("resident", "stream2d", "streamrows")


def probe_table(n_tiles: int, tile_len: int, rows: int = 1,
                device="cpu") -> torch.Tensor:
    """The probe's table, i32[n_tiles, rows, tile_len] = 0, 1, 2, ...
    (tools/stream_probe.py's ``arange``)."""
    return torch.arange(n_tiles * rows * tile_len, dtype=torch.int32,
                        device=device).reshape(n_tiles, rows, tile_len)


def expected(n_tiles: int, tile_len: int, rows: int = 1) -> int:
    """The walk's sum over ``probe_table`` (tools/stream_probe.py::
    _expected, the same formula)."""
    i = np.arange(n_tiles)[:, None]
    j = np.arange(READS)[None, :]
    c = (i * 7 + j * 13) % tile_len
    r = (i * 3 + j * 5) % rows if rows > 1 else 0
    vals = ((i * rows + r) * tile_len + c).astype(np.int64)
    return int(np.int32(vals.sum() & 0xFFFFFFFF))


def check_probe(tab, variant: str, n_ctas: int):
    """Raise ``ValueError`` unless the probe can walk ``tab`` this way."""
    if not isinstance(tab, torch.Tensor) or tab.dtype != torch.int32 \
            or tab.dim() != 3 or not tab.is_contiguous() or tab.numel() == 0:
        raise ValueError("tab must be a non-empty contiguous "
                         "i32[n_tiles, rows, tile_len]")
    _, rows, tile_len = tab.shape
    if variant not in variants_for(rows):
        raise ValueError(f"variant {variant!r} is not one of "
                         f"{variants_for(rows)} for rows={rows}")
    if variant != "resident":
        if tile_len % 4:
            raise ValueError(f"tile_len {tile_len} is not a multiple of 4: "
                             "a bulk copy moves 16-byte multiples")
        if tab.data_ptr() % 16:
            raise ValueError("a bulk copy needs a 16-byte aligned table")
        if 4 * rows * tile_len > SMEM_MAX:
            raise ValueError(f"a {4 * rows * tile_len}-byte tile exceeds "
                             f"the {SMEM_MAX} bytes of shared memory")
    if n_ctas < 1:
        raise ValueError(f"n_ctas must be >= 1, got {n_ctas}")


def stream_probe_plain(tab, variant: str, n_ctas: int = 1) -> torch.Tensor:
    """Plain version of the probe on any device -> i32[n_ctas]."""
    check_probe(tab, variant, n_ctas)
    stream_probe_plain.launches += 1
    n_tiles, rows, tile_len = tab.shape
    src = tab
    if variant != "resident":
        # the staging buffer when tile i's wait returns: the rows the wait
        # covers hold tile i, the others still tile i - 1's (zeros before
        # the first tile); the copies of every row land on the one barrier
        waited = rows
        prev = torch.cat([torch.zeros_like(tab[:1]), tab[:-1]])
        src = torch.cat([tab[:, :waited], prev[:, waited:]], 1)
    dev = tab.device
    i = torch.arange(n_tiles, device=dev)[:, None]
    j = torch.arange(READS, device=dev)[None, :]
    vals = src[i, (i * 3 + j * 5) % rows, (i * 7 + j * 13) % tile_len]
    total = int(vals.to(torch.int64).sum()) & 0xFFFFFFFF
    return torch.full((n_ctas,), int(np.uint32(total).view(np.int32)),
                      dtype=torch.int32, device=dev)


stream_probe_plain.launches = 0


def stream_probe(tab, variant: str, n_ctas: int | None = None) -> torch.Tensor:
    """The probe's walk over ``tab`` -> i32[n_ctas], each CTA's sum (each
    must equal ``expected`` for ``probe_table``).  ``n_ctas`` defaults to
    one per SM on a CUDA device and 1 on the CPU.  CUDA tensors launch
    ``csrc/stream_probe.cu``, CPU tensors run ``stream_probe_plain``.  A
    staged CTA whose copy has not landed after ~0.2 s stops its walk and
    stores the partial sum."""
    if tab.device.type == "cpu":
        return stream_probe_plain(tab, variant, n_ctas or 1)
    if tab.device.type != "cuda":
        raise ValueError(f"stream_probe runs on cuda or cpu, not {tab.device}")
    if n_ctas is None:
        n_ctas = torch.cuda.get_device_properties(
            tab.device).multi_processor_count
    check_probe(tab, variant, n_ctas)
    n_tiles, rows, tile_len = tab.shape
    sums = torch.empty(n_ctas, dtype=torch.int32, device=tab.device)
    lib = build.load_library()
    with torch.cuda.device(tab.device):
        rc = lib.crt_stream_probe(
            tab.data_ptr(), n_tiles, rows, tile_len, _CODES[variant], n_ctas,
            sums.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_stream_probe", rc)
    stream_probe.launches += 1
    return sums


stream_probe.launches = 0
