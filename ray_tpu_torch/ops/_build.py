"""Build the port's hand-written CUDA kernels and load them with ctypes.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``ray_tpu_torch/_build/`` (listed in ``.gitignore``). A library is cached
under a hash of its source, the shared ``csrc/*.cuh`` headers and the
compiler flags, so an edit rebuilds it. The kernels link nothing beyond
nvcc's defaults: ``csrc/hopper.cuh`` looks up libcuda's TMA tensor-map
encoder through the CUDA runtime instead of linking ``-lcuda``.
``ptxas_report`` reads each kernel's registers and spills from a build log.
Nothing here falls back: a missing ``nvcc`` or a failed build or load
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"     # where the CUDA toolkit puts it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> compiler output of the last build (the ptxas -v report included)
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists(CUDA_NVCC):
        path = CUDA_NVCC
    if path is None:
        raise RuntimeError(
            f"nvcc not found on PATH or at {CUDA_NVCC}: the port's CUDA "
            f"kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    # The key covers the shared headers too, so editing one rebuilds all.
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not yet built,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each build took (0.0 for one already cached)."""
    names = list(names) if names is not None else kernel_names()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = stdout + stderr
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SERIALIZED = re.compile(r"wgmma\.mma_async instructions are serialized .*"
                         r"function '([^']+)'")
_TEMPLATE = re.compile(r"\d(fa_[a-z0-9_]+?)ILi(\d+)E")


def _short(mangled: str) -> str:
    m = _TEMPLATE.search(mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def ptxas_report(log: str) -> list:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its name
    (``fa_fwd_bf16<128>`` for a kernel template of the head dim), the
    registers a thread is launched with, the bytes of spill stores and
    loads, the static shared memory (dynamic shared memory is set at launch
    and not in the log), and whether ptxas serialised its wgmma pipeline."""
    serialized = {_short(m.group(1)) for m in _SERIALIZED.finditer(log)}
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = dict(kernel=_short(m.group(1)), registers=None,
                       spill_stores=0, spill_loads=0, smem=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    for k in out:
        k["wgmma_serialized"] = k["kernel"] in serialized
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        path = library_path(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"could not load {path}: {e}") from e
        _libs[name] = lib
    return lib
