"""Ray data parallelism over torch.distributed: the mesh, multi-process
initialisation, and the sharded render and training step."""

from myraytracer_tpu_torch.parallel.mesh import make_mesh, ray_sharding
from myraytracer_tpu_torch.parallel.shard_render import (
    make_train_step,
    merge_params,
    render_aa_sharded,
    render_sharded,
    split_params,
    train_step_sharded,
)

__all__ = [
    "make_mesh",
    "make_train_step",
    "merge_params",
    "ray_sharding",
    "render_aa_sharded",
    "render_sharded",
    "split_params",
    "train_step_sharded",
]
