"""myraytracer_tpu_torch — the ray tracer ported to PyTorch and CUDA.

A port of ``myraytracer_tpu`` (JAX with Pallas kernels for the TPU) to
PyTorch with hand-written CUDA kernels for an NVIDIA H100 (sm_90a). The
JAX package is the reference it is tested against; this package imports
neither it nor JAX.

Layout (module names follow the reference):
    models/    scene authoring and the packed SceneData of tensors
    ops/       cluster cut, cluster scan, shading, shade segment, refit,
               tracer, render and training entry points
    parallel/  split_params / merge_params of the training step
    scenes/    procedural authoring of the ten golden scenes and the
               gallery entry point (python -m myraytracer_tpu_torch.scenes.golden)
    utils/     vector math, PNG reading and writing
    kernels/   nvcc build and ctypes binding of csrc/*.cu
    csrc/      the CUDA kernels (cluster scan, phase-1, shading, shade
               segment forward and backward)

Ported so far: the forward render with adaptive supersampling of every
primitive kind (triangles, spheres, planes, cylinders) and of textured
meshes, and the training step (loss and scene-parameter gradients) of
triangle-only, untextured scenes.
"""

__version__ = "0.1.0"

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.models.light import Light
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.scene import (Scene, SceneData,
                                                scenedata_from_arrays)
from myraytracer_tpu_torch.ops.render import (render, render_aa,
                                               render_loss_grad,
                                               render_loss_grad_image)
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)

__all__ = [
    "Camera",
    "Light",
    "Material",
    "Scene",
    "SceneData",
    "merge_params",
    "render",
    "render_aa",
    "render_loss_grad",
    "render_loss_grad_image",
    "scenedata_from_arrays",
    "split_params",
]
