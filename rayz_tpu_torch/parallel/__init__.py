from .mesh import AXIS, make_mesh, render_sharded, render_sharded_jit
from .multihost import (assemble_global_image, global_mesh, initialize,
                        is_primary_host)

__all__ = [
    "AXIS",
    "make_mesh",
    "render_sharded",
    "render_sharded_jit",
    "initialize",
    "is_primary_host",
    "global_mesh",
    "assemble_global_image",
]
