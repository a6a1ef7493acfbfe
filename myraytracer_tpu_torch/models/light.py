"""Point light source (reference framework ``Light``: position + color,
evidence mytracer.cpp:111-112)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Light:
    position: tuple = (0.0, 0.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
