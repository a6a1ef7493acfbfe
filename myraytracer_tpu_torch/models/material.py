"""Phong material description.

Re-provides the missing framework ``Material`` inferred from reference
call sites (mydata.h:66-71, mytracer.cpp:282-287, 547, 585-589):
ambient/diffuse/specular colors, mirror coefficient, shininess exponent,
and the shadowable flag.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Material:
    """Host-side (scene-authoring) material. Packed to SoA by Scene.build()."""

    ambient: tuple = (0.1, 0.1, 0.1)
    diffuse: tuple = (0.7, 0.7, 0.7)
    specular: tuple = (0.0, 0.0, 0.0)
    mirror: float = 0.0
    shininess: float = 1.0
    shadowable: bool = True

    def as_arrays(self):
        return (
            np.asarray(self.ambient, np.float32),
            np.asarray(self.diffuse, np.float32),
            np.asarray(self.specular, np.float32),
            np.float32(self.mirror),
            np.float32(self.shininess),
            np.float32(1.0 if self.shadowable else 0.0),
        )
