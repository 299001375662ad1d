from .camera import Camera, camera_from_numpy, generate_rays, make_camera
from .scene import (
    DIFFUSE_HEMISPHERE,
    DIFFUSE_UNIT_SPHERE,
    DIFFUSE_UNIT_SPHERE_SURFACE,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_METALLIC,
    TEX_CHECKER,
    TEX_SOLID,
    Scene,
    SceneBuilder,
    scene_from_numpy,
)

__all__ = [
    "Camera",
    "make_camera",
    "camera_from_numpy",
    "generate_rays",
    "Scene",
    "SceneBuilder",
    "scene_from_numpy",
    "MAT_DIFFUSE",
    "MAT_METALLIC",
    "MAT_DIELECTRIC",
    "TEX_SOLID",
    "TEX_CHECKER",
    "DIFFUSE_UNIT_SPHERE",
    "DIFFUSE_UNIT_SPHERE_SURFACE",
    "DIFFUSE_HEMISPHERE",
]
