"""The roofline's arithmetic on a hand-worked case."""

import pytest

from benchmark import roofline


def _cfg():
    return {"dtype": "float32", "resolution": [2, 1],
            "textures": [{"kind": "solid", "color": [1, 1, 1]}],
            "materials": [{"kind": "diffuse", "texture": 0}],
            "spheres": [[0, 0, 0, 1, 0, 0, 0, 0], [0, 0, 5, 1, 0, 0, 0, 0]],
            "quads": [{"corner": [0, 0, 0], "u": [1, 0, 0], "v": [0, 1, 0],
                       "material": 0, "tessellation": 1}]}


def test_scene_work_hand_worked():
    # 10 segments x (2 spheres x 31 + 2 triangles x 51) = 1,640 operations;
    # words: 8 x 2 + 10 x 2 + 5 x 1 + 8 x 1 + 3 x 2 pixels = 55, 220 bytes
    flops, nbytes = roofline.scene_work(_cfg(), 10)
    assert flops == 1640 and nbytes == 220


def test_least_time_takes_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.least_time_s(67e12, 0, kind) == pytest.approx(1.0)
    assert roofline.least_time_s(0, 3.35e12, kind) == pytest.approx(1.0)
    assert roofline.least_time_s(67e12, 6.7e12, kind) == pytest.approx(2.0)
    assert roofline.least_time_s(1, 1, "cpu") is None
