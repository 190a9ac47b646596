"""Mesh construction over the ranks of ``torch.distributed``.

The torch port of ``repro/launch/mesh.py``: a ``DeviceMesh`` with the JAX
package's axis names stands in for a JAX ``Mesh``.  The process group must
be up (``torch.distributed.init_process_group``, or ``torchrun``'s
environment, which ``DeviceMesh`` reads).

Mesh geometry:
  single-pod:  (data=16, model=16)            = 256 ranks
  multi-pod:   (pod=2, data=16, model=16)     = 512 ranks
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group "
                           "(or run under torchrun) before building a mesh")
    return dist.get_world_size()


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = _world()
    if have == need:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    if have < need:
        raise RuntimeError(
            f"need {need} devices for mesh {dict(zip(axes, shape))}, have {have} "
            f"(the process group's world size is {have})")
    # more ranks than needed: the first `need` form the mesh
    return DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """(data = world // model, model) over every rank of the process group."""
    n = _world()
    assert n % model == 0, (n, model)
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))
