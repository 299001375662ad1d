from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .inverse import (
    DEFAULT_TRAINABLE,
    extract_params,
    fit,
    inject_params,
    make_train_step,
    params_from_numpy,
    pixel_loss,
)

__all__ = [
    "DEFAULT_TRAINABLE",
    "extract_params",
    "inject_params",
    "params_from_numpy",
    "pixel_loss",
    "make_train_step",
    "fit",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
]
