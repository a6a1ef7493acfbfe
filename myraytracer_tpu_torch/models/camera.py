"""Pinhole camera with fractional-pixel primary rays (torch).

Counterpart of ``myraytracer_tpu/models/camera.py``: the same look-at
basis, ``tan(fovy * pi / 360)`` half-angle, pixel-centre NDC and
normalized directions, for whole tensors of pixel coordinates at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from myraytracer_tpu_torch.utils import vecmath as vm


@dataclasses.dataclass(frozen=True)
class Camera:
    """Right-handed look-at pinhole camera.

    Integer pixel coordinates address pixel centres; x runs left to
    right, y top to bottom (image row 0 is the top).
    """

    eye: torch.Tensor          # [3]
    center: torch.Tensor       # [3] look-at point
    up: torch.Tensor           # [3]
    fovy: torch.Tensor         # [] full vertical FOV in degrees
    width: int = 512
    height: int = 512

    @staticmethod
    def make(eye, center, up, fovy: float, width: int, height: int,
             device="cpu") -> "Camera":
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return Camera(f32(eye), f32(center), f32(up), f32(fovy), int(width),
                      int(height))

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, eye=self.eye.to(device), center=self.center.to(device),
            up=self.up.to(device), fovy=self.fovy.to(device))

    def _basis(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        view = vm.normalize(self.center - self.eye)
        right = vm.normalize(vm.cross(view, self.up))
        up = vm.cross(right, view)
        return view, right, up

    def primary_rays(self, xs: torch.Tensor, ys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Primary rays through fractional pixel coords ``xs``, ``ys``.

        Returns (origins, directions), each ``[..., 3]`` on the device of
        ``xs``; directions are normalized.
        """
        cam = self.to(xs.device)
        view, right, up = cam._basis()
        tan_half = torch.tan(cam.fovy * (math.pi / 360.0))
        aspect = self.width / self.height
        # NDC in [-1, 1]; pixel x=0 maps to the centre of the leftmost column
        u = ((xs + 0.5) / self.width) * 2.0 - 1.0
        v = 1.0 - ((ys + 0.5) / self.height) * 2.0
        d = (view
             + (u * tan_half * aspect)[..., None] * right
             + (v * tan_half)[..., None] * up)
        d = vm.normalize(d)
        o = cam.eye.expand(d.shape)
        return o, d
