"""The slim launch path of the package's CUDA kernels.

A wrapper on this path pays, per call, for its checks, the output's
``torch.empty``, one ctypes call and the kernel launch, and for nothing
else:

  * :class:`KernelEntry` resolves its exported C function once — the
    library built and loaded by :func:`~.cuda_build.load_library`, the
    function's ``argtypes`` and ``restype`` set — and keeps it, so a call
    takes no lock and looks nothing up by name;
  * :func:`current_stream` is PyTorch's raw current-stream accessor (the one
    its generated launchers use): the kernel still launches on the caller's
    current stream, so a CUDA graph capture sees it, without building a
    ``torch.cuda.Stream`` object per call;
  * the entry takes the card's index and makes that device current itself
    (``csrc/device_guard.cuh``), instead of the wrapper entering
    ``with torch.cuda.device(...)`` around the call.

An entry returns the launch's ``cudaGetLastError()``; a nonzero code raises
RuntimeError.  Nothing here is touched at import: the library is built at
the first call.
"""

from __future__ import annotations

import ctypes

import torch

from rplidar_ros2_driver_tpu_torch.utils.cuda_build import load_library

VP, I = ctypes.c_void_p, ctypes.c_int
# cumulative entry resolutions by exported name (utils/guards.py reads
# them: a warmed loop resolves nothing)
resolves: dict[str, int] = {}


class KernelEntry:
    """One exported kernel entry of library ``library`` with argument
    types ``argtypes`` (``VP`` for a pointer or the stream, ``I`` for an
    int); returns an int cudaError_t."""

    __slots__ = ("library", "name", "argtypes", "fn")

    def __init__(self, library: str, name: str, argtypes: list) -> None:
        self.library = library
        self.name = name
        self.argtypes = argtypes
        self.fn = None

    def resolve(self):
        """Build and load the library when needed; set and keep the C
        function with its argument and return types."""
        fn = getattr(load_library(self.library), self.name)
        fn.argtypes = self.argtypes
        fn.restype = I
        self.fn = fn
        resolves[self.name] = resolves.get(self.name, 0) + 1
        return fn

    def __call__(self, *args) -> None:
        fn = self.fn
        if fn is None:
            fn = self.resolve()
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError {rc}")


def count_launch(totals: dict, by_card: dict, name: str, card: int) -> None:
    """Count one launch of kernel ``name`` on card ``card`` in a kernel
    module's ``launch_counts`` (by name) and ``card_launches`` (by (name,
    card)): the wrapper calls this where it launches, and nowhere else."""
    totals[name] += 1
    by_card[name, card] = by_card.get((name, card), 0) + 1


def current_stream(device_index: int) -> int:
    """The raw ``cudaStream_t`` of the current stream on card
    ``device_index``, as an int."""
    return torch._C._cuda_getCurrentRawStream(device_index)
