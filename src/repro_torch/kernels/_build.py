"""Build the CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and becomes its own shared
library, so all of them compile at once (one ``nvcc`` process per source,
started together).  Libraries go to ``build/repro_torch_kernels/`` at the
repository root, named by a hash of the source and the command line, so an
edited source rebuilds and an unchanged one is reused.  Nothing here runs at
import: the first launch of a kernel builds every library that is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "support_count_packed": CSRC / "support_count_packed.cu",
    "rule_match": CSRC / "rule_match.cu",
    "support_count": CSRC / "support_count.cu",
}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> list[str]:
    """The command line that builds one source into a shared library."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(output), str(source),
    ]


def _library_path(name: str) -> Path:
    src = SOURCES[name]
    key = hashlib.sha256(
        src.read_bytes() + " ".join(nvcc_command(Path(src.name), Path("lib.so"))).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel, and
    print each compiler's ``-Xptxas -v`` report once.  Returns name -> path."""
    paths = {name: _library_path(name) for name in SOURCES}
    missing = {name: p for name, p in paths.items() if not p.exists()}
    if not missing:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, path in missing.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(SOURCES[name], tmp, nvcc)
        procs[name] = (tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, path, proc) in procs.items():
        report, _ = proc.communicate()
        print(f"[build] nvcc {SOURCES[name].name}:\n{report.strip()}", flush=True)
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building what is missing first."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                if n not in _LIBS:
                    _LIBS[n] = _bind(n, ctypes.CDLL(str(p)))
            lib = _LIBS[name]
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "support_count_packed":
        fn = lib.support_count_packed_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        lib.support_count_packed_scratch_bytes.argtypes = [i32, i32, i32]
        lib.support_count_packed_scratch_bytes.restype = ctypes.c_longlong
    elif name == "rule_match":
        fn = lib.rule_match_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
        fn.restype = i32
        lib.rule_match_scratch_bytes.argtypes = [i32]
        lib.rule_match_scratch_bytes.restype = ctypes.c_longlong
    elif name == "support_count":
        fn = lib.support_count_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    return lib
