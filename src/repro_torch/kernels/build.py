"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` alone
into its own shared library (headers shared between sources sit beside
them as ``csrc/*.cuh``), loaded with ``ctypes`` — no PyTorch headers
in the build, so a kernel builds in seconds. Libraries land in
``kernels/_build/`` (git-ignored), named by a hash of the source and the
flags: a library is rebuilt only when its source changes. Building and
loading happen at first use, never at import, so the package imports on
hosts without CUDA. A failed build or load raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("moe_gmm", "moe_gmm_q", "decode_attn")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library of source ``csrc/<name>.cu`` is cached. The
    hash covers the shared headers (``csrc/*.cuh``) too."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns name -> library path."""
    with _lock:
        running = {n: _start(n) for n in names}
        errors = []
        for n, job in running.items():
            if job is None:
                continue
            proc, tmp, out = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on csrc/{n}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build((name,))[name]
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


@functools.cache
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_sms(device) -> int:
    """Streaming multiprocessors of CUDA `device` (the launch plans size
    their grids by it)."""
    import torch
    dev = torch.device(device)
    return _sm_count(torch.cuda.current_device() if dev.index is None
                     else dev.index)


def ptxas_report(name: str) -> str:
    """Compile ``csrc/<name>.cu`` once more with ``-Xptxas -v`` into a
    scratch file and return the compiler's report: each kernel's
    registers, spill stores and loads, and static shared memory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / f"{name}.so"), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
    return proc.stdout + proc.stderr


if __name__ == "__main__":
    # python -m repro_torch.kernels.build [--ptxas] [source ...]
    args = sys.argv[1:]
    verbose = "--ptxas" in args
    names = [a for a in args if a != "--ptxas"] or list(SOURCES)
    if verbose:
        for n in names:
            print(f"== csrc/{n}.cu\n{ptxas_report(n)}", flush=True)
    else:
        for n, path in build(names).items():
            print(f"{n}: {path}")
