"""pack_ms.edit: host ms of the synced rebuild after an edit
(``RenderLayer._sync_scene``: ``Scene.device``, ``_CudaPipeline`` with its
table packing, upload and light table), mean over the window's edits."""

from benchmark import devtrace


def read(rec):
    return devtrace.mean_span(rec, "sync_scene")
