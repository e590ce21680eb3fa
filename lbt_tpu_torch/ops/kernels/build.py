"""Build and load the port's CUDA kernels from the sources in the checkout.

CUDA C++ sources under ``lbt_tpu_torch/csrc`` are compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds.  Builds
happen at first use into ``lbt_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources, the headers beside them
and the flags, so a changed source rebuilds and an unchanged one loads the
cached library.  ``ptxas`` reports each kernel's registers, shared memory
and spills (``-Xptxas -v``) into a ``.ptxas.txt`` file beside the library;
:func:`ptxas_report` reads it and :func:`sass_counts` counts instructions
in the library's SASS.  No flag enables fast math: K1 relies on subnormal
inputs surviving.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library(name: str, sources, extra_flags=(),
                  csrc: Path = CSRC_DIR) -> Path:
    """Compile ``sources`` (file names under ``csrc``) into
    ``_build/lib<name>-<hash>.so`` unless that file exists; return it.
    The hash covers the flags, the sources and every header in ``csrc``."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    h = hashlib.sha256(" ".join(flags).encode())
    paths = [Path(csrc) / s for s in sources]
    for p in paths + sorted(Path(csrc).glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *flags, "-o", tmp, *map(str, paths)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def int8_gemm_library(csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """K2 (``int8_gemm.cu`` under ``csrc``), built on first use."""
    lib = ctypes.CDLL(str(build_library("int8_gemm", ["int8_gemm.cu"],
                                        csrc=csrc)))
    fn = lib.lbt_int8_gemm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.lbt_int8_gemm_tn
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def conv_bwd_library(csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """The int8 conv backward's dgrad and wgrad (``conv_bwd.cu`` under
    ``csrc``), built on first use."""
    lib = ctypes.CDLL(str(build_library("conv_bwd", ["conv_bwd.cu"],
                                        csrc=csrc)))
    fn = lib.lbt_conv_dgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.lbt_conv_wgrad
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def quantize_library(csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """K1 (``quantize.cu`` under ``csrc``), built on first use."""
    lib = ctypes.CDLL(str(build_library("quantize", ["quantize.cu"],
                                        csrc=csrc)))
    fn = lib.lbt_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# #4 / #5's libraries, one a noise kind (``csrc/conv_fused.cuh``): the
# source and the suffix of its entry points' names
CONV_FUSED_KINDS = {0: ("conv_fused.cu", ""),
                    1: ("conv_fused_threefry.cu", "_threefry"),
                    2: ("conv_fused_rbg.cu", "_rbg")}


def noise_kind(mode) -> int:
    """The kind of #4 / #5's library that draws noise mode ``mode`` (None
    or 0 rounds to nearest): 0 none and the hashes, 1 threefry, 2
    Philox."""
    return {3: 1, 4: 2}.get(mode, 0)


@functools.cache
def conv_fused_library(kind: int = 0, csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """Kernels #4 and #5 of one noise kind (:data:`CONV_FUSED_KINDS`:
    ``conv_fused.cu``, ``conv_fused_threefry.cu`` or
    ``conv_fused_rbg.cu`` under ``csrc``, one library each so that their
    builds run side by side), built on first use."""
    source, suffix = CONV_FUSED_KINDS[kind]
    lib = ctypes.CDLL(str(build_library(source[:-3], [source], csrc=csrc)))
    for entry in ("lbt_conv3x3_fused", "lbt_conv1x1_fused"):
        fn = getattr(lib, entry + suffix)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_uint32] * 8
                       + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def ptxas_report(lib: Path) -> dict:
    """``{kernel: {"registers", "smem", "spill_stores", "spill_loads"}}``
    from the ``-Xptxas -v`` log of ``lib`` (mangled kernel names)."""
    out, name = {}, None
    path = Path(lib).with_suffix(".ptxas.txt")
    for line in path.read_text().splitlines() if path.exists() else ():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out[name].update(registers=int(m.group(1)),
                             smem=int(m.group(2) or 0))
    return {k: v for k, v in out.items() if "registers" in v}


def sass_counts(lib: Path, opcode: str = "IMMA"):
    """``{kernel: number of ``opcode`` instructions}`` in ``lib``'s SASS,
    from ``cuobjdump`` beside ``nvcc``; None where there is no
    ``cuobjdump``."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name and re.search(rf"\b{opcode}\b", line):
            out[name] += 1
    return out


def short_name(mangled: str) -> str:
    """``kernel<args>`` of a mangled kernel name, through ``c++filt``
    where there is one (the mangled name otherwise)."""
    tool = shutil.which("c++filt")
    if tool is None:
        return mangled
    name = subprocess.run([tool, mangled], capture_output=True, text=True
                          ).stdout.strip() or mangled
    name = re.sub(r"^void |\(anonymous namespace\)::|\(.*\)$", "", name)
    return re.sub(r"\s+", "", name.replace("signed char", "int8")
                  .replace("short", "int16"))

