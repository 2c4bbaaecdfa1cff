"""Device meshes for sharded encode and decode (port of
``dct_tpu.parallel.mesh``).

The codec's parallel axes:

  * ``data``   — independent frames (the batch axis);
  * ``stripe`` — tile stripes within a frame: blocks share no pixels, so
    stripes need no halo exchange; only histograms, bit lengths and the
    assembled outputs cross ranks.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank
of the default process group, with dims named ("data", "stripe"); each
rank runs the codec on its own device (``device``). In place of the
reference's NamedShardings, ``frame_slice`` and ``row_slice`` give a
rank's share of an array that every rank holds whole, as every process of
the reference holds the host array: a rank uploads only its slice.

Collective tensors live where the process group's backend needs them
(``collective_device``): on the card under NCCL, on the host under gloo.
The caller chooses the backend when it initialises the group; nothing
here switches it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
STRIPE_AXIS = "stripe"


def make_mesh(
    n_data: int | None = None,
    n_stripe: int | None = None,
    device_type: str | None = None,
) -> DeviceMesh:
    """2D ("data", "stripe") mesh over every rank of the default process
    group (``dist.get_world_size()``).

    With only one axis size given, the other takes the remaining ranks;
    with neither, every rank is on the stripe axis (single-stream encode,
    the BASELINE.json config-4 shape). device_type None means the card,
    and raises where there is none; "cpu" runs the plain versions."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device_type='cpu' to "
                               "run the plain versions")
        device_type = "cuda"
    n = dist.get_world_size()
    if n_data is None and n_stripe is None:
        n_data, n_stripe = 1, n
    elif n_data is None:
        n_data = n // n_stripe
    elif n_stripe is None:
        n_stripe = n // n_data
    if n_data * n_stripe != n:
        raise ValueError(f"mesh {n_data}x{n_stripe} != {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(n_data, n_stripe),
                      mesh_dim_names=(DATA_AXIS, STRIPE_AXIS))


def initialize_distributed(**kwargs) -> None:
    """Multi-process entry: ``dist.init_process_group`` passthrough (the
    caller names the backend, the address, the world size and the rank).

    Encode jobs are stateless and idempotent per stripe, so a failure is
    handled by running the failed stripe set again: there is no elastic
    state to rebuild."""
    dist.init_process_group(**kwargs)


def shape(mesh: DeviceMesh) -> tuple[int, int]:
    """(n_data, n_stripe) of a make_mesh mesh; raises for a mesh that is
    not one (other dims, or not every rank of the default group)."""
    if tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS, STRIPE_AXIS):
        raise ValueError(f"mesh dims {mesh.mesh_dim_names} are not "
                         f"({DATA_AXIS!r}, {STRIPE_AXIS!r})")
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the default "
                         "process group")
    n_data, n_stripe = mesh.shape
    return int(n_data), int(n_stripe)


def coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's (data, stripe) coordinate."""
    d, s = mesh.get_coordinate()
    return int(d), int(s)


def device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def entry_device(mesh: DeviceMesh, requested=None) -> torch.device:
    """An entry point's device when it is given a mesh: the mesh's, which
    ``requested`` (a device argument, when given) must name."""
    dev = device(mesh)
    if requested is not None and torch.device(requested).type != dev.type:
        raise ValueError(f"device {requested} differs from the mesh's "
                         f"{dev.type}")
    return dev


def collective_device(mesh: DeviceMesh) -> torch.device:
    """Where collective tensors must lie for the default group's backend:
    the current card under NCCL, the host under gloo."""
    backend = dist.get_backend()
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"unsupported process-group backend {backend!r}")


def frame_slice(mesh: DeviceMesh, f_pad: int) -> slice:
    """This rank's frames of an (f_pad, ...) stack (its data coordinate);
    f_pad must divide over the data axis."""
    n_data = shape(mesh)[0]
    if f_pad % n_data:
        raise ValueError(f"{f_pad} frames must divide over the {n_data}-rank "
                         "data axis")
    k = f_pad // n_data
    d = coordinate(mesh)[0]
    return slice(d * k, (d + 1) * k)


def row_slice(mesh: DeviceMesh, ph: int) -> slice:
    """This rank's rows of a mesh-padded plane of ph rows (its stripe
    coordinate); ph must divide over the stripe axis."""
    n_stripe = shape(mesh)[1]
    if ph % n_stripe:
        raise ValueError(f"{ph} rows must divide over the {n_stripe}-rank "
                         "stripe axis")
    k = ph // n_stripe
    s = coordinate(mesh)[1]
    return slice(s * k, (s + 1) * k)
