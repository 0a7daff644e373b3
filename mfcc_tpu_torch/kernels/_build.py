"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/<name>_<hash>.so` at the root of the checkout, at first use; the hash
covers the source, the shared headers `csrc/*.cuh` and the flags, so an
edited source or header rebuilds. A source listed in `PARTS` is compiled as
that many objects in parallel nvcc processes (`-D<NAME>_PART=k`: part 0 its
C interface, the others its kernels' instantiations, each part's alone),
then linked into the one library. At most `os.cpu_count()` nvcc processes
run at once in a process, whatever builds run in parallel. Bindings
pass pointers as `ctypes.c_void_p` and the stream from
`torch.cuda.current_stream().cuda_stream`. A build failure raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# sources compiled in parts: csrc/frontend.cu's C interface (part 0) and its
# sixteen groups of kernel instantiations (csrc/frontend.cu FRONTEND_PARTS)
PARTS = {"frontend": 17}
_NVCC_SLOTS = threading.BoundedSemaphore(os.cpu_count() or 1)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use"
    )


def _run(args: list[str], what: str) -> str:
    with _NVCC_SLOTS:
        res = subprocess.run([nvcc(), *args], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} (exit {res.returncode}):\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def compile_source(src: pathlib.Path, out: pathlib.Path, parts: int = 0,
                   include: pathlib.Path = CSRC, flags: tuple[str, ...] = NVCC_FLAGS,
                   name: str | None = None) -> str:
    """nvcc of `src` (its headers from `include`) into the shared library
    `out`: in one process, or as `parts` objects compiled in parallel
    (-D<NAME>_PART=k, `name` the source's, by default its file's stem) and
    linked. Returns the compiler's output (ptxas register, shared-memory and
    spill lines), the parts' in order."""
    if not parts:
        return _run([*flags, "-I", str(include), "-o", str(out), str(src)], str(src))
    macro = f"-D{(name or src.stem).upper()}_PART"
    objs = [out.with_name(f"{out.stem}.part{k}.o") for k in range(parts)]
    obj_flags = [f for f in flags if f != "-shared"]
    with concurrent.futures.ThreadPoolExecutor(parts) as pool:
        logs = list(pool.map(lambda k: _run(
            [*obj_flags, "-c", f"{macro}={k}", "-I", str(include), "-o", str(objs[k]), str(src)],
            f"{src} part {k}"), range(parts)))
    try:
        logs.append(_run([*flags, "-o", str(out), *map(str, objs)], f"the link of {out.name}"))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(logs)


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/<name>.cu unless its build exists; returns the shared
    library's path and the compiler's output (ptxas register, shared-memory
    and spill lines)."""
    src = CSRC / f"{name}.cu"
    parts = PARTS.get(name, 0)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode() + f" parts {parts}".encode()
    lib = BUILD_DIR / f"{name}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        try:
            text = compile_source(src, tmp, parts)
        except RuntimeError:
            tmp.unlink(missing_ok=True)
            raise
        log.write_text(text)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[0]))
