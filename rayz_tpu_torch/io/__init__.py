from .image import read_ppm, to_u8, write_png, write_ppm

__all__ = ["to_u8", "write_ppm", "write_png", "read_ppm"]
