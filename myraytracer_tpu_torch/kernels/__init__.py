"""Hand-written CUDA kernels of the port: build, binding, launch counts."""

from myraytracer_tpu_torch.kernels._build import (LAUNCHES, build,
                                                   kernel_resources, library,
                                                   reset_launches)

__all__ = ["LAUNCHES", "build", "kernel_resources", "library",
           "reset_launches"]
