"""Build and load the input pipeline's host libraries from ``native/*.cc``.

The C++ sources under ``native/`` are shared with ``lbt_tpu`` as source
only.  The port compiles them with ``g++`` and ``native/Makefile``'s flags
(the same flags give the same bits: the CPU tests compare the port's
batches with ``lbt_tpu``'s, which ``make`` builds from the same source),
into ``lbt_tpu_torch/_build/`` (listed in ``.gitignore``), never into
``native/``.  A library is named by a hash of its source, the flags and
what ``-march=native`` resolves to on this machine, so a checkout copied
to another host rebuilds rather than loading code for another CPU.  Builds
happen at first use, under a file lock: test workers may build at once.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

from lbt_tpu_torch.ops.kernels.build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

CXX = "g++"
# native/Makefile: CXXFLAGS, then -shared
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp",
             "-Wall", "-shared")


@functools.cache
def _target() -> bytes:
    """The target options ``-march=native`` resolves to here."""
    return subprocess.run(
        [CXX, "-march=native", "-Q", "--help=target"], capture_output=True,
        check=True).stdout


def build_host_library(name: str, source: str, libs=()) -> Path:
    """Compile ``native/<source>`` into ``_build/lib<name>-<hash>.so``
    unless that file exists; return it.  A failed build raises with the
    compiler's output."""
    src = NATIVE_DIR / source
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS + tuple(libs)).encode())
    h.update(_target())
    h.update(src.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while we waited
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [CXX, *CXX_FLAGS, "-o", tmp, str(src), *libs],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{CXX} failed building {name} from {src} "
                    f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


@functools.cache
def loader_library() -> ctypes.CDLL:
    """The in-memory loader (``native/loader.cc``), built on first use."""
    lib = ctypes.CDLL(str(build_host_library("lbt_loader", "loader.cc")))
    lib.lbt_loader_create.restype = ctypes.c_void_p
    lib.lbt_loader_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int,
    ]
    lib.lbt_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lbt_loader_next.restype = ctypes.c_int
    lib.lbt_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.lbt_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def tfrecord_library() -> ctypes.CDLL:
    """The TFRecord pipeline (``native/tfrecord.cc``, libjpeg), built on
    first use."""
    lib = ctypes.CDLL(str(build_host_library(
        "lbt_tfrecord", "tfrecord.cc", libs=("-ljpeg",))))
    lib.lbt_tfr_create.restype = ctypes.c_void_p
    lib.lbt_tfr_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.lbt_tfr_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lbt_tfr_next.restype = ctypes.c_int
    lib.lbt_tfr_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.lbt_tfr_skipped.restype = ctypes.c_long
    lib.lbt_tfr_skipped.argtypes = [ctypes.c_void_p]
    lib.lbt_tfr_destroy.argtypes = [ctypes.c_void_p]
    lib.lbt_tfr_count.restype = ctypes.c_long
    lib.lbt_tfr_count.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
    return lib
