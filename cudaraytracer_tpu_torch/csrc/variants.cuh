// The instantiations the image kernels are compiled for: one
// X(rects, tris, vattrs, images, features) per flag combination, where
// features are the F_* bits of search.cuh (noise 1, media 2, box media 4,
// yaw-rotated box media 8, motion 16, NEE 32).  The .cu files expand these lists
// into their launch chains and ops/cuda/build.py::variants reads them for
// the Python wrappers, which pick one of these for a scene
// (ops/cuda/render_kernel.py::resolve_variant) or raise: the two sides
// cannot disagree.  A new combination is one line here.
#pragma once

// The megakernel: the eight without a feature bit (spheres only, +rects,
// +rects+tris, +vattrs, each with and without images), then marble (N),
// bounce (V), smoke (NMB), cornell_smoke (NMBR), the all-feature probe
// (NMBRV) and book2_final (NMBV, with triangles and images); then with
// NEE (E): default and cornell (rects), mirror_room (rects, images),
// cornell_mesh_light (triangles), smoke, cornell_smoke, the probe,
// book2_final, mesh_smooth and smooth OBJ models (vattrs), terrain and
// terrain_big (vattrs, images) and bounce (V).
#define CRT_RENDER_VARIANTS(X) \
  X(0, 0, 0, 0, 0)             \
  X(0, 0, 0, 1, 0)             \
  X(1, 0, 0, 0, 0)             \
  X(1, 0, 0, 1, 0)             \
  X(1, 1, 0, 0, 0)             \
  X(1, 1, 0, 1, 0)             \
  X(1, 1, 1, 0, 0)             \
  X(1, 1, 1, 1, 0)             \
  X(0, 0, 0, 0, 1)             \
  X(0, 0, 0, 0, 16)            \
  X(1, 0, 0, 0, 7)             \
  X(1, 0, 0, 0, 15)            \
  X(1, 0, 0, 0, 31)            \
  X(1, 1, 0, 1, 23)            \
  X(1, 0, 0, 0, 32)            \
  X(1, 0, 0, 1, 32)            \
  X(1, 1, 0, 0, 32)            \
  X(1, 0, 0, 0, 39)            \
  X(1, 0, 0, 0, 47)            \
  X(1, 0, 0, 0, 63)            \
  X(1, 1, 0, 1, 55)            \
  X(1, 1, 1, 0, 32)            \
  X(1, 1, 1, 1, 32)            \
  X(0, 0, 0, 0, 48)

// The G-buffer: the same eight, then marble (N), the rect scenes with
// media (smoke, cornell_smoke, the probe: NM) and book2_final (NM).  Only
// the noise and media bits change its code.
#define CRT_GBUFFER_VARIANTS(X) \
  X(0, 0, 0, 0, 0)              \
  X(0, 0, 0, 1, 0)              \
  X(1, 0, 0, 0, 0)              \
  X(1, 0, 0, 1, 0)              \
  X(1, 1, 0, 0, 0)              \
  X(1, 1, 0, 1, 0)              \
  X(1, 1, 1, 0, 0)              \
  X(1, 1, 1, 1, 0)              \
  X(0, 0, 0, 0, 1)              \
  X(1, 0, 0, 0, 3)              \
  X(1, 1, 0, 1, 3)

// The streamed layout (search.cuh::closest_hit_streamed; the tables
// beyond the card's budget): the megakernel's instantiations for the scene
// classes that route there or that the checks force: spheres
// (rtow_final), rects (default, the dry run's streamed shard), terrain
// and terrain_big (vattrs, images) without and with NEE, book2_final
// without and with NEE, the all-feature probe with NEE, and OBJ meshes on
// the ground rect (every flag set that render --obj gives), flat and
// smooth, without and with NEE.
#define CRT_RENDER_STREAM_VARIANTS(X) \
  X(0, 0, 0, 0, 0)                    \
  X(1, 0, 0, 0, 0)                    \
  X(1, 1, 1, 1, 0)                    \
  X(1, 1, 1, 1, 32)                   \
  X(1, 1, 0, 1, 23)                   \
  X(1, 1, 0, 1, 55)                   \
  X(1, 0, 0, 0, 63)                   \
  X(1, 1, 0, 0, 0)                    \
  X(1, 1, 1, 0, 0)                    \
  X(1, 1, 0, 0, 32)                   \
  X(1, 1, 1, 0, 32)

// The G-buffer's streamed instantiations for the same scene classes
// (only the noise and media bits change its code).
#define CRT_GBUFFER_STREAM_VARIANTS(X) \
  X(0, 0, 0, 0, 0)                     \
  X(1, 0, 0, 0, 0)                     \
  X(1, 1, 1, 1, 0)                     \
  X(1, 1, 0, 1, 3)                     \
  X(1, 0, 0, 0, 3)                     \
  X(1, 1, 0, 0, 0)                     \
  X(1, 1, 1, 0, 0)
