"""Build a CUDA C++ source into a shared library with `nvcc`, at first use.

The library has a plain C interface and is loaded with ctypes (no PyTorch
headers, so a build takes seconds). It lands in `build/repro_torch/` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source builds anew and an unchanged one is loaded as it is. A
failed build raises with the compiler's output; nothing falls back. With
metrics on (obs), each nvcc run counts `cuda.builds` and its seconds
(`cuda.build_seconds`), each library found built `cuda.loads`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.obs import cudahooks

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found ($CUDA_HOME/bin, PATH, "
                       "/usr/local/cuda/bin); the CUDA kernels are built "
                       "from source at first use")


def library_path(source: Path) -> Path:
    """Where the library built from `source` lives."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, source: Path, out: Path):
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


def build(source: Path) -> Path:
    """Compile `source` unless its library is already built; its path."""
    out = library_path(source)
    if out.exists():
        cudahooks.count_load()
        return out
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = nvcc_command(nvcc, source, tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent loader sees all or none
    cudahooks.count_build(time.perf_counter() - t0)
    return out


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
