"""Builds the port's CUDA kernels from the sources in `csrc/` at first use.

Each `.cu` file compiles with a plain `nvcc -shared` into a library with a
C interface, loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). Libraries are named by a digest of their sources and flags and go
to `build/kernels/` at the repository root, which `.gitignore` lists; a
library already built from the same sources is reused. Sources start
compiling together, one `nvcc` each, and each splits its device code's
optimisation over the host's cores (`--split-compile=0`: the decode
source's many instantiations are the build's long pole). A failed build
raises: nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "decode_attention", "moe_gmm", "ssm_scan")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "--split-compile=0", *ARCH_FLAGS]

TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and strides

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler that torch.utils.cpp_extension finds ($CUDA_HOME, then
    nvcc on PATH, then the toolkit's usual install directory)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all at once, and
    return name -> library path. The compiler's register and shared-memory
    report (`-Xptxas -v`) is kept beside each library as `.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    jobs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use in this process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def alignment(*tensors) -> int:
    """The largest power of two dividing every tensor's base address."""
    ptrs = [t.data_ptr() for t in tensors]
    return min(p & -p for p in ptrs) if all(ptrs) else 0


def error_text(rc: int) -> str:
    """What a kernel library's nonzero return code means: -2 and 10000 + a
    CUresult come from the tensor-map encoder (`csrc/hopper.cuh`), anything
    else is a cudaError_t or -1 for an argument the entry point refuses."""
    if rc == -2:
        return "the CUDA driver has no cuTensorMapEncodeTiled"
    if rc >= 10000:
        return f"TMA tensor-map encode failed (CUresult {rc - 10000})"
    return f"launch failed (code {rc})"
