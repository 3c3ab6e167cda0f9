"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/<name>-<hash>.so``
(a plain C interface, no PyTorch headers, so a build takes seconds), at
first use, from the sources in this package only.  The file name carries a
hash of the source and the shared headers, so an edited kernel is rebuilt
and a stale library is never loaded.  ``build_all`` starts one nvcc per
source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C functions: name -> (source, argtypes); every one returns an int:
# a launching one 0 on success and otherwise a cudaError_t or -1 (bad
# arguments), the *_workspace and *_launches helpers a count
SIGNATURES = {
    "flash_prefill": ("flash_prefill", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "decode_attention": ("decode_attention", [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "topk": ("topk", [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "topk_workspace": ("topk", [_I, _I, _I]),
    "topk_launches": ("topk", [_I, _I]),
    "dequant_matmul": ("dequant_matmul", [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P]),
    "dequant_matmul_workspace": ("dequant_matmul", [_I, _I, _I, _I, _I]),
    "dequant_matmul_launches": ("dequant_matmul", [_I, _I, _I, _I, _I]),
}
SOURCES = sorted({src for src, _ in SIGNATURES.values()})

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:16]}.so"


def build_all(sources: List[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all nvcc processes at
    once.  Returns nvcc's report (registers, shared memory, spills) per
    source that was built; raises if any build fails."""
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[s] = out
        if proc.returncode != 0:
            failed.append(f"{s}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(s))   # atomic: no half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        build_all([source])
        lib = ctypes.CDLL(str(library_path(source)))
        for name, (src, argtypes) in SIGNATURES.items():
            if src == source:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    return lib


def call(name: str, *args) -> None:
    """Call the exported C function ``name``; raise if it returns non-zero."""
    lib = library(SIGNATURES[name][0])
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} (code {rc})")
