"""Production mesh construction (counterpart of ``repro.launch.mesh``).

The production mesh is a ``DeviceMesh`` of (16, 16) over ("data",
"model") -- 256 cards -- or (2, 16, 16) over ("pod", "data", "model")
for two pods.  The dry-run plans it from one process: the mesh stands
over a *fake* process group (``torch.testing``'s ``FakeStore`` and the
"fake" backend) of 256 or 512 ranks in which this process is rank 0, so
a collective is dispatched and recorded but moves nothing.  Every mesh
is built inside a function, never at import, and ``teardown`` (or the
``production_mesh`` / ``fake_mesh`` context managers) destroys its
group, after which the process may build another, a real one included.

``make_mesh`` builds a mesh over a real group: gloo for CPU tensors,
NCCL for CUDA ones.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_fake_mesh(shape: Sequence[int], names: Sequence[str],
                   device_type: str = "cpu", rank: int = 0) -> DeviceMesh:
    """A mesh of ``shape`` over a fake process group of ``prod(shape)``
    ranks, this process being ``rank``.  Raises if a process group
    exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: tear it down "
                           "before building a fake mesh")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        return init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=tuple(names))
    except BaseException:
        dist.destroy_process_group()
        raise


def make_production_mesh(multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 cards a pod; 2 pods = 512 cards multi-pod, over a fake
    group (this process is rank 0).  Call ``teardown`` when done."""
    shape, names = PRODUCTION[multi_pod]
    return make_fake_mesh(shape, names)


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device: str = "cuda", init_method: Optional[str] = None,
              rank: int = 0) -> DeviceMesh:
    """A mesh over a real group: gloo for ``device`` "cpu", NCCL for
    "cuda".  Uses the default group if one exists (a launcher's, or one
    process of a spawned set); otherwise initialises one of
    ``prod(shape)`` ranks from ``init_method`` (e.g. ``file://...`` or
    ``tcp://localhost:<port>``) as ``rank``."""
    device_type = "cuda" if str(device).startswith("cuda") else "cpu"
    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("no process group: pass init_method")
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def teardown() -> None:
    """Destroy the default process group (and with it every mesh over
    it), if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cpu") -> Iterator[DeviceMesh]:
    """``make_fake_mesh`` for the ``with`` block, torn down after it."""
    mesh = make_fake_mesh(shape, names, device_type)
    try:
        yield mesh
    finally:
        teardown()


@contextlib.contextmanager
def production_mesh(multi_pod: bool = False) -> Iterator[DeviceMesh]:
    """``make_production_mesh`` for the ``with`` block, torn down after
    it."""
    shape, names = PRODUCTION[multi_pod]
    with fake_mesh(shape, names) as mesh:
        yield mesh


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch: ("pod","data") multi-pod, ("data",)
    single."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
