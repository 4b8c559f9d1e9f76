"""Build a CUDA C++ source of the port with ``nvcc`` and bind it with ctypes.

Shared by the hand-written CUDA kernels (K5 in ``csrc/fused_block_bwd.cu``,
K6 in ``csrc/split_site.cu``).  A source is compiled at first use for
Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared library
with a plain C interface, ``build/kernels/<name>_<hash>.so`` of the
checkout, keyed by the first 16 hex digits of a SHA-256 over the source
and every header it names with ``#include "..."`` (:func:`source_key`;
an edit to a shared header rebuilds each source that includes it), with
ptxas's report (registers, shared memory, spills of each kernel) beside it
as ``<name>_<hash>.ptxas.txt``.  A library already built for the same
source is loaded as it is.  A failed build raises with nvcc's output.
Nothing is built or loaded when this module is imported.
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
from typing import Dict, Sequence, Tuple

BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_LOADED: Dict[pathlib.Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """The nvcc of ``CUDA_HOME``, of ``/usr/local/cuda`` or on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the port's CUDA kernels cannot be built")
    return found


def source_key(source: pathlib.Path) -> str:
    """16 hex digits of a SHA-256 over ``source`` and, in the order first
    named, each header it or a header of it includes with quotes (looked
    up beside the file that names it)."""
    digest = hashlib.sha256()
    seen, todo = set(), [pathlib.Path(source).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        digest.update(path.name.encode() + b"\0" + text + b"\0")
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(text)]
    return digest.hexdigest()[:16]


def build(source: pathlib.Path, name: str) -> pathlib.Path:
    """Compile ``source`` unless its library exists; return the library."""
    digest = source_key(source)
    lib_path = BUILD_DIR / f"{name}_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run([nvcc(), *FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({out.returncode}):"
                           f"\n{out.stdout}\n{out.stderr}")
    (BUILD_DIR / f"{name}_{digest}.ptxas.txt").write_text(out.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def load(source: pathlib.Path, name: str,
         functions: Dict[str, Tuple[Sequence, object]]) -> ctypes.CDLL:
    """Build (once per source hash) and load ``source``; set each entry
    point's ``(argtypes, restype)`` from ``functions``."""
    lib_path = build(source, name)
    with _LOCK:
        lib = _LOADED.get(lib_path)
        if lib is None:
            lib = ctypes.CDLL(str(lib_path))
            for fn, (argtypes, restype) in functions.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _LOADED[lib_path] = lib
    return lib
