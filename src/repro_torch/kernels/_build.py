"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``_build/<name>-<hash>.so`` next to the package (the directory is listed
in ``.gitignore``), with a plain C interface and no PyTorch headers, so a
build takes seconds. The hash covers the source, the shared headers
``csrc/*.cuh`` and the flags: a library is built at first use and reused
while none of them changes. ``build_all`` starts one nvcc per
source, all at once, and waits for every one of them.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("fused_expand", "gather_dist_tile", "bitset_dist", "gather_dist",
           "l2dist", "flash_attention", "flash_attention_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "fused_expand": ("fused_expand_f32", [_P] * 6 + [_I] * 6 + [_P]),
    "gather_dist_tile": ("gather_dist_tile_f32", [_P] * 4 + [_I] * 5 + [_P]),
    "bitset_dist": ("bitset_dist_u32", [_P] * 3 + [_I] * 5 + [_P]),
    "gather_dist": ("gather_dist", [_P] * 4 + [_I] * 6 + [_P]),
    "l2dist": ("l2dist", [_P] * 4 + [_I] * 5 + [_P]),
    "flash_attention": ("flash_attention",
                        [_P] * 4 + [_I] * 7 + [_F, _I, _P]),
    "flash_attention_f32": ("flash_attention_f32",
                            [_P] * 5 + [_I] * 8 + [_F, _I, _P]),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    """The library of ``name``, keyed by its source, every shared header
    (``csrc/*.cuh``, which a source may include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, in parallel.

    Raises with the compiler's output if any build fails; the ptxas report
    (registers, shared memory, spills) of each build lands in PTXAS_LOG.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        PTXAS_LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel ``name`` with its argtypes set."""
    return getattr(library(name), SIGNATURES[name][0])


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of ``opcode`` (e.g. "HGMMA") the built library
    of kernel ``name`` holds, from ``cuobjdump -sass``."""
    path = build_all([name])[name]
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    return sum(line.split("*/", 1)[-1].lstrip().startswith(opcode)
               for line in sass.splitlines())
