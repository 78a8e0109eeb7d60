"""Build and load the port's CUDA kernels as one plain-C shared library.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
file (one ``nvcc`` per source, all started together), the objects are
linked into ``librepro_torch_kernels.so``, and the library is loaded with
``ctypes``.  The build lands in ``build/repro_torch_kernels/<hash>/`` at
the repository root, keyed by a hash of the sources and flags, so a
checkout builds its kernels at first use and reuses them afterwards.
Nothing is built when this module is imported: :func:`library` builds on
first call.

Each C entry point launches on the stream it is given (the wrapper passes
``torch.cuda.current_stream().cuda_stream``) and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

# C signatures of the entry points (argtypes, restype int)
SIGNATURES = {
    "repro_wt_dequant": [P, P, P, LL, I, I, P],
    "repro_wt_cast": [P, P, LL, I, P],
    "repro_flash_attention": [P, P, P, P, I, I, I, I, I, I, I,
                              LL, LL, LL, LL, LL, LL, LL, LL, LL,
                              I, I, F, P],
    "repro_decode_attention": [P, P, P, P, P, I, I, I, I, I, I, I, F, P],
}


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        cand = "/usr/local/cuda/bin/nvcc"
    if cand is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(PATH and /usr/local/cuda/bin searched)")
    return cand


class KernelLibrary:
    """The built library: ``lib`` (ctypes handle), where it lives, how long
    its build took (0 when it was already built) and the compiler log."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s
        self.log = log
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int

    def __getattr__(self, name: str):
        return getattr(self.lib, name)


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def _build(out_dir: Path) -> str:
    """Compile every source in parallel, link, and move the result into
    ``out_dir`` atomically.  Returns the compiler log."""
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(tmp / (s.stem + ".o")) for s in _sources()]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    (tmp / "build.log").write_text("\n".join(log))
    try:
        os.replace(tmp, out_dir)
    except OSError:               # another process finished first
        shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(log)


def library() -> KernelLibrary:
    """The loaded kernel library, built first if this checkout has none."""
    global _library
    with _lock:
        if _library is None:
            out_dir = BUILD_ROOT / source_hash()
            t0 = time.perf_counter()
            built = not (out_dir / LIB_NAME).exists()
            if built:
                log = _build(out_dir)
            else:
                log_path = out_dir / "build.log"
                log = log_path.read_text() if log_path.exists() else ""
            lib = ctypes.CDLL(str(out_dir / LIB_NAME))
            _library = KernelLibrary(lib, out_dir / LIB_NAME,
                                     time.perf_counter() - t0 if built
                                     else 0.0, log)
        return _library


def status() -> Dict[str, Any]:
    """Whether the library was built in this process, and where."""
    with _lock:
        lib = _library
    if lib is None:
        return {"built": False, "path": str(BUILD_ROOT / source_hash()
                                            / LIB_NAME)}
    return {"built": True, "path": str(lib.path), "build_s": lib.build_s}


class LaunchCounter:
    """Launches of one kernel in this process.  A wrapper adds one where
    it launches its kernel and nowhere else, so a run can show which
    kernels its path went through."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self):
        with self._lock:
            self._n += 1

    def reset(self):
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
