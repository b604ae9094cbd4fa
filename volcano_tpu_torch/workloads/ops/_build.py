"""Build and load the port's CUDA kernels.

At first use, every `volcano_tpu_torch/csrc/*.cu` is compiled by `nvcc`
for sm_90a (one `nvcc` per source, all started together), linked into
`build/kernels/<hash of the sources and flags>/libvtp_torch_kernels.so`
under the repository root, and loaded with `ctypes`.  The library has a
plain C interface: no PyTorch headers, so a build takes seconds.  A file
lock keeps two processes from building into one directory at once.  A
missing or failing `nvcc` raises with its output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libvtp_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas=-v"]

_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library's path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / (out_dir.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():            # another process built it
            return lib_path
        out_dir.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = []
        for src in sources():
            obj = out_dir / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text = proc.communicate()[0]
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{text}")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
        link = subprocess.run(
            [exe, *ARCH, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
