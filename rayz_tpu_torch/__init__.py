"""rayz_tpu_torch — the PyTorch + CUDA port of ``rayz_tpu``.

A second package beside the JAX reference, laid out the same way
(``models/``, ``ops/``, ``diff/``, ``parallel/``, ``io/``, ``utils/``).
Plain tensor code is PyTorch; the render, record, gather and replay
kernels are hand-written CUDA for Hopper (``csrc/``), built at first use.
This package imports torch and numpy, never JAX. The dense integrator
(``render``) is plain torch.
"""

from .io import read_ppm, to_u8, write_png, write_ppm
from .models import (Camera, Scene, SceneBuilder, camera_from_numpy,
                     generate_rays, make_camera, scene_from_numpy)
from .models import scenes
from .ops import (RenderConfig, pick_engine, render, render_diff,
                  render_diff_pp, render_fast, render_jit, render_megakernel,
                  render_megakernel_sharded, render_wavefront, trace_rays)
from .diff import (DEFAULT_TRAINABLE, extract_params, fit, inject_params,
                   make_train_step, params_from_numpy, pixel_loss)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Scene",
    "SceneBuilder",
    "make_camera",
    "camera_from_numpy",
    "generate_rays",
    "scene_from_numpy",
    "scenes",
    "RenderConfig",
    "render",
    "render_jit",
    "trace_rays",
    "render_fast",
    "render_megakernel",
    "render_megakernel_sharded",
    "render_wavefront",
    "render_diff",
    "render_diff_pp",
    "pick_engine",
    "DEFAULT_TRAINABLE",
    "extract_params",
    "inject_params",
    "params_from_numpy",
    "pixel_loss",
    "make_train_step",
    "fit",
    "to_u8",
    "write_ppm",
    "write_png",
    "read_ppm",
]
