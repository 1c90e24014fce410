"""Build the port's native sources into plain-C shared libraries.

Each kernel's ``.cu`` file under ``csrc/`` is compiled at first use with
``nvcc`` for ``sm_90a`` (and the LETOR parser's ``.cpp`` with ``g++``,
``data/native.py``) into ``build/ultra_pytorch_tpu_torch/`` at the root of
the checkout, and loaded with ``ctypes``. The library's file name
carries a hash of its flags, its sources and every header they include
(``#include "..."``, recursively), so a stale build is never loaded. Nothing includes PyTorch's headers, which keeps a build to
seconds. ``nvcc`` is found through ``CUDA_HOME``, then
``torch.utils.cpp_extension.CUDA_HOME``, then ``PATH``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "ultra_pytorch_tpu_torch"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    path: Path
    seconds: float  # 0.0 when an up-to-date build was found
    log: str        # nvcc's output, including ptxas's -v report


def find_nvcc() -> str:
    from torch.utils import cpp_extension

    for home in (os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def with_headers(sources: Sequence[Path]) -> List[Path]:
    """`sources` followed by every header they include by a quoted path,
    found beside the including file, each once."""
    files, todo = [], [Path(s) for s in sources]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header.is_file():
                todo.append(header)
    return files


def library_path(name: str, sources: Sequence[Path],
                 flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """``lib<name>-<hash>.so`` under BUILD_DIR, the hash taken over the
    flags, the sources and the headers they include."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in with_headers(sources):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str, sources: Sequence[Path],
                  compiler: Optional[str] = None,
                  flags: Sequence[str] = NVCC_FLAGS) -> BuiltLibrary:
    """Compile `sources` with `compiler` (default nvcc) and `flags` into
    ``library_path(name, sources, flags)`` unless it exists. The compiler
    writes a name of this process's own and the file is renamed into
    place, so ranks that build at once never load half a library."""
    path = library_path(name, sources, flags)
    log_path = path.with_suffix(".log")
    if path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return BuiltLibrary(path, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    cmd = [compiler or find_nvcc(), *flags, "-o", str(tmp),
           *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed building {name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, path)
    return BuiltLibrary(path, seconds, log)
