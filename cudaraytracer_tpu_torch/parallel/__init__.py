from .tiling import Mesh, make_mesh, render_sharded_sample

__all__ = ["Mesh", "make_mesh", "render_sharded_sample"]
