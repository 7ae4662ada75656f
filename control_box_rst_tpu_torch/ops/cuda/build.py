"""Build and load the CUDA kernels of ``csrc/``.

Each ``.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. A library is one
specialisation of one source: its compile-time constants are passed as
``-D`` defines (``NZ``, ``NC``). Nothing is built or looked up when this
module is imported; a wrapper asks for its library at its first launch.
A failed build raises, and so does a missing ``nvcc``.

Libraries go to ``build/cuda_kernels`` at the root of the checkout. The file
name carries a hash of source, the headers of ``csrc/`` it includes, flags
and defines, so an edited source rebuilds and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, Mapping, Sequence, Tuple

_PKG_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG_ROOT / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

Spec = Tuple[pathlib.Path, Mapping[str, int]]  # (source, defines)

_libs: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], ctypes.CDLL] = {}
_lock = threading.Lock()
# what nvcc printed for each library built with ``verbose`` (file name ->
# stdout + stderr: ptxas's registers and spills per kernel)
BUILD_OUTPUT: Dict[str, str] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH, /usr/local/cuda): "
        "the CUDA kernels are compiled from csrc/ at first use"
    )


def build_dir() -> pathlib.Path:
    """Where the shared libraries go: ``build/cuda_kernels`` at the root of
    the checkout."""
    return _PKG_ROOT.parent / "build" / "cuda_kernels"


def _flags(defines: Mapping[str, int]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={int(v)}" for k, v in sorted(defines.items()))


def local_headers(source: pathlib.Path) -> Tuple[pathlib.Path, ...]:
    """The headers beside ``source`` that it includes by ``#include "name"``
    (one level: the headers of ``csrc/`` include nothing of ``csrc/``)."""
    names = re.findall(r'^#include\s+"([^"]+)"', source.read_text(), re.M)
    return tuple(source.parent / n for n in names)


def library_path(source: pathlib.Path, defines: Mapping[str, int]) -> pathlib.Path:
    flags = _flags(defines)
    text = b"".join(f.read_bytes() for f in (source, *local_headers(source)))
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:12]
    spec = "_".join(f"{k.lower()}{int(v)}" for k, v in sorted(defines.items()))
    return build_dir() / f"lib{source.stem}_{spec}_{tag}.so"


def build_all(specs: Sequence[Spec], verbose: bool = False) -> Tuple[pathlib.Path, ...]:
    """Compile every (source, defines) whose library is not there yet, one
    ``nvcc`` process each, all started together; returns the libraries'
    paths in the order given. With ``verbose`` the compilers' output
    (``-Xptxas -v``: registers, spills) is printed."""
    outs, running = [], []
    for source, defines in specs:
        out = library_path(source, defines)
        outs.append(out)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *_flags(defines)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((out, tmp, cmd, proc))
    failures = []
    for out, tmp, cmd, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}")
            continue
        if verbose:
            print(stdout + stderr, flush=True)
            BUILD_OUTPUT[out.name] = stdout + stderr
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return tuple(outs)


def ptxas_report(text: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of one ``-Xptxas -v`` output: registers, spill stores and
    loads (bytes), stack frame (bytes), keyed by the kernel's mangled name."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def build(source: pathlib.Path, defines: Mapping[str, int],
          verbose: bool = False) -> pathlib.Path:
    """Compile one specialisation of one source if its library is not there
    yet; returns the library's path."""
    return build_all([(source, defines)], verbose)[0]


def load(source: pathlib.Path, defines: Mapping[str, int], declare) -> ctypes.CDLL:
    """The loaded library of (source, defines), built at the first request.
    ``declare(lib)`` sets ``restype`` / ``argtypes`` of its C functions and
    checks that the library is the specialisation asked for; it runs once
    per library."""
    key = (str(source), tuple(sorted((k, int(v)) for k, v in defines.items())))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, defines)))
            declare(lib)
            _libs[key] = lib
    return lib
