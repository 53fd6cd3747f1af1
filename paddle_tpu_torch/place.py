"""Device identity (reference ``paddle/fluid/platform/place.h:25-49``).

``CUDAPlace`` is the real device: an entry point given no place runs on
``cuda:0`` and raises when CUDA is absent.  It never falls back to the
CPU on its own; only a caller that passes ``CPUPlace()`` (the CPU tests)
runs there.
"""

from __future__ import annotations

import torch

__all__ = ["CPUPlace", "CUDAPlace", "default_place", "torch_device"]


class Place:
    def __eq__(self, other):
        return type(self) is type(other) and getattr(self, "device_id", 0) == \
            getattr(other, "device_id", 0)

    def __hash__(self):
        return hash((type(self).__name__, getattr(self, "device_id", 0)))


class CPUPlace(Place):
    def __repr__(self):
        return "CPUPlace"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: CUDA is not available (pass CPUPlace() to run "
                f"on the CPU)")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{self!r}: only {torch.cuda.device_count()} CUDA "
                f"device(s) present")
        return torch.device("cuda", self.device_id)


def default_place():
    """The place an entry point uses when its caller names none."""
    return CUDAPlace(0)


def torch_device(place):
    """``torch.device`` of ``place`` (None = :func:`default_place`);
    raises when that place's device is absent."""
    return (place if place is not None else default_place()).torch_device()
