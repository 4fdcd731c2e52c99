"""Build `csrc/*.cu` with nvcc at first use and load it with ctypes.

Each source becomes its own shared library with a plain C interface
(`extern "C"` launchers that take raw pointers, sizes and a stream, and
return `cudaGetLastError()`), so no PyTorch header is compiled and a build
takes seconds. Libraries land in `nshmc_tpu_torch/_build/` (gitignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                       "the CUDA kernels cannot be built on this host")


def library_path(source: str) -> str:
    """Where the library for csrc/<source> is (or will be) built."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str) -> tuple[str, str]:
    """Compile csrc/<source> if its library is missing; returns (path, the
    compiler's ptxas report, empty when the library was already built)."""
    out = library_path(source)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source} (rc={r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, r.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library for csrc/<source>, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(path)
            _libs[source] = lib
        return lib


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel of an `nvcc -Xptxas -v` report: its name with
    template arguments, registers, spills and shared memory."""
    lines, name = [], "?"
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            m = re.search(r"[A-Za-z_]+_kernel", mangled)
            tail = mangled[m.end():].split("Ev")[0] if m else ""
            args = (["bf16"] if "__nv_bfloat16" in tail else ["f32"] if tail.startswith("If")
                    else []) + re.findall(r"Li(\d+)E", tail)
            name = (m.group(0) if m else mangled) + (f"<{','.join(args)}>" if args else "")
        elif "spill" in line:
            lines.append(f"{name}: {line.strip()}")
        elif "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
