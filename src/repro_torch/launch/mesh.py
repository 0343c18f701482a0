"""Production mesh definition (counterpart of ``repro/launch/mesh.py``).

A function, not a module-level constant: importing this module touches no
process group and no device.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.parallel.mesh import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"): 256 or 512 ranks in the default process group (a fake one,
    ``parallel.mesh.fake_process_group``, for a capture)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != want:
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh {shape} needs "
            f"a default process group of {want} ranks; "
            + ("there is none" if world is None else f"it has {world}"))
    return make_mesh(shape, axes, device_type)
