"""Hand-written CUDA kernels of the port: build, binding, launch counts."""

from myraytracer_tpu_torch.kernels._build import (LAUNCHES, build, library,
                                                   reset_launches)

__all__ = ["LAUNCHES", "build", "library", "reset_launches"]
