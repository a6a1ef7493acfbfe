"""myraytracer_tpu_torch — the ray tracer ported to PyTorch and CUDA.

A port of ``myraytracer_tpu`` (JAX with Pallas kernels for the TPU) to
PyTorch with hand-written CUDA kernels for an NVIDIA H100 (sm_90a). The
JAX package is the reference it is tested against; this package imports
neither it nor JAX.

Layout (module names follow the reference):
    models/    scene authoring and the packed SceneData of tensors
    ops/       cluster cut, cluster scan, shading, tracer, render
    scenes/    procedural authoring of the office scene
    utils/     vector math
    kernels/   nvcc build and ctypes binding of csrc/*.cu
    csrc/      the CUDA kernels (cluster scan, phase-1, shading)

Ported so far: the forward render of triangle-only, untextured scenes.
"""

__version__ = "0.1.0"

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.models.light import Light
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.scene import (Scene, SceneData,
                                                scenedata_from_arrays)
from myraytracer_tpu_torch.ops.render import render

__all__ = [
    "Camera",
    "Light",
    "Material",
    "Scene",
    "SceneData",
    "render",
    "scenedata_from_arrays",
]
