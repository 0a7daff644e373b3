"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/<name>_<hash>.so` at the root of the checkout, at first use; the hash
covers the source, the shared headers `csrc/*.cuh` and the flags, so an
edited source or header rebuilds. Bindings
pass pointers as `ctypes.c_void_p` and the stream from
`torch.cuda.current_stream().cuda_stream`. A build failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use"
    )


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/<name>.cu unless its build exists; returns the shared
    library's path and the compiler's output (ptxas register, shared-memory
    and spill lines)."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    lib = BUILD_DIR / f"{name}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        res = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {src} (exit {res.returncode}):\n"
                f"{res.stdout}{res.stderr}"
            )
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[0]))
