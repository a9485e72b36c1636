"""What every wrapper of a hand-written kernel does the same way.

  * `Kernel(lib, entry, argtypes)`: one C entry of csrc/<lib>.cu, loaded at
    its first call (kernels/build.py); `argtypes` are its arguments before
    the last, a cudaStream_t, and it returns a cudaError_t. A call with
    those arguments and `stream_of=` a tensor launches on that device's
    current stream, raises on an error and counts one launch under `entry`
    in utils/profiling.py's store, beside the program's counters.
  * `device_kind(name, tensors)`: the rule that picks a wrapper's route,
    "cpu" (the plain version) or "cuda" (the kernel).
  * `require_aligned(name, t, nbytes)`: a tensor a kernel reads or writes
    in vectors of nbytes must start on such a boundary.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Optional, Sequence

import torch

from hashnerf_torch.kernels import build
from hashnerf_torch.utils import profiling

# Every Kernel, by its entry's name
KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    def __init__(self, lib: str, entry: str, argtypes: Sequence):
        self.lib, self.entry = lib, entry
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self._fn = None
        profiling.register(entry)
        KERNELS[entry] = self

    @property
    def fn(self):
        """The C entry itself, stream last: a call of it is neither checked
        nor counted."""
        if self._fn is None:
            fn = getattr(build.load(self.lib), self.entry)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args, stream_of: torch.Tensor) -> None:
        err = self.fn(*args, torch.cuda.current_stream(stream_of.device).cuda_stream)
        build.check(err, self.entry)
        profiling.count(self.entry)


def device_kind(name: str, tensors: Iterable[Optional[torch.Tensor]]) -> str:
    """"cpu" or "cuda" where every tensor (None skipped) is on the CPU or on
    one CUDA device; ValueError for meta tensors, mixed devices, two cards."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type in ("cpu", "cuda"):
            return dev.type
    raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}, want the CPU (plain "
                     "version) or one CUDA device")


def require_aligned(name: str, t: Optional[torch.Tensor], nbytes: int) -> None:
    if t is not None and t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data at {t.data_ptr():#x} not {nbytes}-byte aligned")
