"""The device mesh — port of ``spark_rapids_tpu/parallel/mesh.py``.

The reference runs one SPMD program over a ``jax.sharding.Mesh``
(``shard_map``) and exchanges with XLA collectives. The port keeps the
single controller: a :class:`Mesh` is an ordered list of
``torch.device`` s, one per shard along :data:`PART_AXIS`, and a mesh
program works on **lists of per-shard values**, shard ``s`` on
``mesh.devices[s]``. The collectives here are functions over such lists.
Shards run one after another on each device's current stream, so shards
that share one card show the program's correctness and the exchange's
cost, not a speed-up.

The list may repeat a device: ``[cuda:0] * 4`` is four shards on one
card, the counterpart of the reference's virtual CPU devices in its
tests, and ``[cpu] * n`` is the port's CPU test mesh. Between cards a
tensor moves with ``Tensor.to``, which orders the copy after the source
stream's pending work and before the destination's, so the source stays
alive until the copy is done. Multi-host execution (``torch.distributed``)
is not part of this module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

PART_AXIS = "part"

#: CUDA runtime and driver messages that mean a device is gone or
#: unusable, rather than a program fault. Matched conservatively by
#: :func:`is_device_loss`; anything else is a program error.
_DEVICE_LOSS_MARKERS = ("busy or unavailable", "uncorrectable ECC error",
                        "uncorrectable NVLink error", "fallen off the bus",
                        "driver shutting down")


class MeshDegradedError(RuntimeError):
    """A device of the mesh was lost, or failed its health probe,
    mid-query."""

    def __init__(self, reason: str, failed_devices: Sequence = ()):
        self.reason = reason
        self.failed_devices = list(failed_devices)
        detail = f"mesh degraded: {reason}"
        if self.failed_devices:
            detail += f" (failed devices: {self.failed_devices})"
        super().__init__(detail)


def is_device_loss(exc: BaseException) -> bool:
    """Whether an error reads as a lost device: only the known CUDA
    messages for a lost or unavailable device match."""
    msg = str(exc)
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


class Mesh:
    """Shard devices along :data:`PART_AXIS`, in shard order."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        #: Every shard lives on one device: exchanges stay on it.
        self.one_device = len(set(self.devices)) == 1

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def probe_devices(devices: Optional[Sequence] = None) -> list:
    """The devices that fail a one-element copy and synchronize (all
    visible cards by default); empty when every device answers."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    failed = []
    for d in devices:
        d = torch.device(d)
        try:
            torch.zeros(1, device=d).cpu()
        except RuntimeError:
            failed.append(d)
    return failed


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``, or over the first ``n_devices`` visible
    cards (all of them by default). Raises when fewer cards are visible
    than asked for, or none."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else n_devices
        if have < want or want < 1:
            raise ValueError(f"need {max(want, 1)} CUDA devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(want)]
    return Mesh(devices)


# --------------------------------------------------------------------------
# Collectives over lists of per-shard tensors
# --------------------------------------------------------------------------


def replicate(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` on every shard's device (the same tensor where it already
    lies there)."""
    return [x.to(d) for d in mesh.devices]


def axis_index(mesh: Mesh) -> List[torch.Tensor]:
    """Each shard's position along the axis, an int32 scalar on its
    device."""
    return [torch.tensor(s, dtype=torch.int32, device=d)
            for s, d in enumerate(mesh.devices)]


def all_to_all(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``xs[s]`` is shard ``s``'s ``[n_parts, ...]`` send buffer; receiver
    ``d`` gets row ``d`` of every sender's buffer, stacked in sender
    order (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``). On one
    device that is one stack; across cards one copy per pair."""
    if mesh.one_device:
        return list(torch.stack(list(xs), dim=1).unbind(0))
    return [torch.stack([x[d].to(dev) for x in xs])
            for d, dev in enumerate(mesh.devices)]


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's value stacked along a new leading axis, on every
    shard (``jax.lax.all_gather``, not tiled)."""
    dev0 = mesh.devices[0]
    return replicate(mesh, torch.stack([x.to(dev0) for x in xs]))


def _reduce(mesh: Mesh, xs: Sequence[torch.Tensor], op: str):
    stacked = all_gather(mesh, xs)[0]
    if op == "sum":
        out = stacked.sum(0, dtype=stacked.dtype)
    else:
        out = stacked.amin(0) if op == "min" else stacked.amax(0)
    return replicate(mesh, out)


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sum over shards, on every shard."""
    return _reduce(mesh, xs, "sum")


def pmin(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise minimum over shards, on every shard."""
    return _reduce(mesh, xs, "min")


def pmax(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise maximum over shards, on every shard."""
    return _reduce(mesh, xs, "max")
