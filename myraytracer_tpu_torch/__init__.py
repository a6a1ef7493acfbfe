"""myraytracer_tpu_torch — the ray tracer ported to PyTorch and CUDA.

A port of ``myraytracer_tpu`` (JAX with Pallas kernels for the TPU) to
PyTorch with hand-written CUDA kernels for an NVIDIA H100 (sm_90a). The
JAX package is the reference it is tested against; this package imports
neither it nor JAX.

Layout (module names follow the reference):
    models/    scene authoring, the packed SceneData of tensors, OBJ/OFF
               meshes (objio) and .sce scene files (sceneio)
    ops/       cluster cut, cluster scan, shading, shade segment, refit,
               tracer, render and training entry points
    parallel/  ray data parallelism over torch.distributed: the mesh,
               multi-process initialisation, the sharded render, AA and
               training step, and the multi-process dryrun
               (python -m myraytracer_tpu_torch.parallel.dryrun)
    runtime/   the native (C++) BVH builder, opt-in (native=True)
    scenes/    procedural authoring of the ten golden scenes and the
               gallery entry point (python -m myraytracer_tpu_torch.scenes.golden)
    utils/     vector math, PNG reading and writing, runtime checks,
               timing and profiling
    kernels/   nvcc build and ctypes binding of csrc/*.cu
    csrc/      the CUDA kernels (cluster scan, phase-1, shading, shade
               segment forward and backward, BVH walk)
    inverse.py InverseRenderer: fit scene and camera parameters to images
    bench.py   the office 1920x1080 benchmark
    cli.py     python -m myraytracer_tpu_torch render|fit|bench

Ported so far: the forward render with adaptive supersampling and the
training step (loss and scene-parameter gradients), both over every
primitive kind (triangles, spheres, planes, cylinders) and textured
meshes, through any of the three triangle methods (the cluster scan, the
BVH walk, the brute-force oracle; "auto" is the walk); scene files,
inverse rendering (on one device, or sharded with ``mesh=``), the
sharded render, AA and training step over torch.distributed
(``render_sharded``, ``render_aa_sharded``, ``train_step_sharded``), the
native BVH builder and the command line: everything the JAX package
does. The entry points take the reference's argument order:
``render(scene, camera, cfg, tile, clamp)``,
``render_aa(scene, camera, cfg, tile, ...)``,
``render_loss_grad(scene, o, d, target, cfg, tile)`` and
``render_loss_grad_image(scene, camera, target, cfg, tile)``.

From a shell, on the GPU (``--backend cpu`` runs the kernels' plain
versions on the CPU; without it and without a GPU each verb exits 2)::

    python -m myraytracer_tpu_torch render --scene examples/demo.sce --out demo.png
    python -m myraytracer_tpu_torch fit --golden o_05_cube --target t.png
    python -m myraytracer_tpu_torch bench
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
from myraytracer_tpu_torch.parallel import (make_mesh, make_train_step,
                                            merge_params, render_aa_sharded,
                                            render_sharded, split_params,
                                            train_step_sharded)

__all__ = [
    "Camera",
    "Light",
    "Material",
    "Scene",
    "SceneData",
    "make_mesh",
    "make_train_step",
    "merge_params",
    "render",
    "render_aa",
    "render_aa_sharded",
    "render_loss_grad",
    "render_loss_grad_image",
    "render_sharded",
    "scenedata_from_arrays",
    "split_params",
    "train_step_sharded",
]
