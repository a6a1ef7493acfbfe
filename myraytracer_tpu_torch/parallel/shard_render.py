"""Scene parameters as a flat dict of tensors (torch).

Counterpart of ``split_params`` / ``merge_params`` in
``myraytracer_tpu/parallel/shard_render.py``: the float tensor fields of
a SceneData are its differentiable parameters, minus the acceleration
structure (``bvh_``/``cl_`` prefixes), whose bounds are traversal
topology and get no gradient. The sharded render and train step are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS, SceneData

#: acceleration-structure arrays: not scene parameters
_ACCEL_PREFIXES = ("bvh_", "cl_")


def split_params(scene: SceneData) -> Dict[str, torch.Tensor]:
    """The differentiable (float) leaves of ``scene`` as a flat dict."""
    return {name: getattr(scene, name) for name in ARRAY_FIELDS
            if not name.startswith(_ACCEL_PREFIXES)
            and getattr(scene, name).is_floating_point()}


def merge_params(scene: SceneData, params: Dict[str, torch.Tensor]
                 ) -> SceneData:
    """``scene`` with its float leaves replaced by ``params``."""
    return dataclasses.replace(scene, **params)
