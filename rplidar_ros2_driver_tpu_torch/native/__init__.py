"""ctypes bindings for the native I/O runtime (the repo's ``native/src``:
protocol codec, serial/TCP/UDP channels, async transceiver).

The PyTorch package's copy of the JAX package's ``native/__init__.py``
with its own build: ``load()`` compiles the repo's ``native/src/*.cc``
with g++ into ``build/native_torch/`` beside the package (git-ignored),
keyed on a hash of the sources, the header and the flags, and never
writes into ``native/``.  A build lands under a temporary name and is
renamed into place, under an exclusive ``fcntl.flock`` on a lock file in
the same directory, so processes that start at once (test workers, a
node and a tool) never write the same file and never load half a
library.  Callers that can run without native I/O catch
``NativeUnavailable``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = _REPO_ROOT / "native"
BUILD_DIR = _REPO_ROOT / "build" / "native_torch"
SOURCES = ("src/codec.cc", "src/channel.cc", "src/transceiver.cc")
HEADER = "include/rpl_native.h"
CXXFLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

# result codes (rpl_native.h)
RPL_OK = 0
RPL_TIMEOUT = -1
RPL_ERR = -2
RPL_CLOSED = -3
RPL_TOOSMALL = -4

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built/loaded on this host."""


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rpl_encode_command.restype = ctypes.c_int
    lib.rpl_encode_command.argtypes = [ctypes.c_uint8, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]

    lib.rpl_decoder_create.restype = ctypes.c_void_p
    lib.rpl_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.rpl_decoder_reset.argtypes = [ctypes.c_void_p]
    lib.rpl_decoder_feed.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.rpl_decoder_pending.restype = ctypes.c_size_t
    lib.rpl_decoder_pending.argtypes = [ctypes.c_void_p]
    lib.rpl_decoder_pop.restype = ctypes.c_int
    lib.rpl_decoder_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), u8p, ctypes.c_size_t,
    ]

    for name in ("rpl_serial_channel_create",):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    for name in ("rpl_tcp_channel_create", "rpl_udp_channel_create"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rpl_channel_open.restype = ctypes.c_int
    lib.rpl_channel_open.argtypes = [ctypes.c_void_p]
    lib.rpl_channel_close.argtypes = [ctypes.c_void_p]
    lib.rpl_channel_is_open.restype = ctypes.c_int
    lib.rpl_channel_is_open.argtypes = [ctypes.c_void_p]
    lib.rpl_channel_write.restype = ctypes.c_int
    lib.rpl_channel_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.rpl_channel_read.restype = ctypes.c_int
    lib.rpl_channel_read.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t, ctypes.c_int]
    lib.rpl_channel_set_dtr.restype = ctypes.c_int
    lib.rpl_channel_set_dtr.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rpl_channel_cancel.argtypes = [ctypes.c_void_p]
    lib.rpl_channel_destroy.argtypes = [ctypes.c_void_p]

    lib.rpl_transceiver_create.restype = ctypes.c_void_p
    lib.rpl_transceiver_create.argtypes = [ctypes.c_void_p]
    lib.rpl_transceiver_destroy.argtypes = [ctypes.c_void_p]
    lib.rpl_transceiver_start.restype = ctypes.c_int
    lib.rpl_transceiver_start.argtypes = [ctypes.c_void_p]
    lib.rpl_transceiver_stop.argtypes = [ctypes.c_void_p]
    lib.rpl_transceiver_send.restype = ctypes.c_int
    lib.rpl_transceiver_send.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.rpl_transceiver_wait_message.restype = ctypes.c_int
    lib.rpl_transceiver_wait_message.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), u8p, ctypes.c_size_t,
    ]
    lib.rpl_transceiver_wait_message_ts.restype = ctypes.c_int
    lib.rpl_transceiver_wait_message_ts.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        u8p, ctypes.c_size_t,
    ]
    lib.rpl_transceiver_reset_decoder.argtypes = [ctypes.c_void_p]
    lib.rpl_transceiver_error.restype = ctypes.c_int
    lib.rpl_transceiver_error.argtypes = [ctypes.c_void_p]
    lib.rpl_transceiver_rx_priority.restype = ctypes.c_int
    lib.rpl_transceiver_rx_priority.argtypes = [ctypes.c_void_p]
    return lib


def library_path() -> Path:
    """Where the library lands for the current sources and flags."""
    text = b"".join((SRC_DIR / s).read_bytes() for s in (*SOURCES, HEADER))
    digest = hashlib.sha256(text + " ".join(CXXFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librpl_native_{digest[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library unless it is there (always with ``force``):
    one g++ over the three sources into a temporary file, renamed into
    place, all under the build directory's file lock.  Returns its path;
    raises NativeUnavailable with the compiler's output on failure."""
    try:
        out = library_path()
    except OSError as e:
        raise NativeUnavailable(f"native sources not found under {SRC_DIR}: {e}") from e
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)  # released when the file closes
        if out.exists() and not force:
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-I", str(SRC_DIR / "include"),
               *(str(SRC_DIR / s) for s in SOURCES), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            tmp.unlink(missing_ok=True)
            detail = getattr(e, "stderr", "") or str(e)
            raise NativeUnavailable(f"native build failed: {detail}") from e
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out


_load_error: NativeUnavailable | None = None


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Load (building if necessary) the native library.

    Failure is cached: one failed build costs one compiler invocation per
    process, not one per connect attempt (the driver's factory and every
    FSM reconnect call this).  ``rebuild=True`` clears the cache and
    compiles again."""
    global _lib, _load_error
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        if _load_error is not None and not rebuild:
            raise _load_error
        try:
            path = build(force=rebuild)
        except NativeUnavailable as e:
            _load_error = e
            raise
        try:
            _lib = _configure(ctypes.CDLL(str(path)))
        except OSError as e:
            _load_error = NativeUnavailable(f"cannot load {path}: {e}")
            raise _load_error from e
        _load_error = None
        return _lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False
