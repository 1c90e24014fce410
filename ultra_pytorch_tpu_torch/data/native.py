"""ctypes binding of the native LETOR parser (``csrc/letor_parser.cpp``).

The port's counterpart of the JAX package's ``data/native.py``. The port
keeps its own copy of the C++ source and builds it at first use with
``g++ -O3 -fPIC -shared -std=c++17`` into ``build/ultra_pytorch_tpu_torch/``
(``ops/kernels/build.py``: a hashed name, written under a name of the
building process's own and renamed into place, so ranks that start at
once never load half a library). It is host code, not a device kernel:
the loaders in ``data/dataset.py`` parse in Python when the library
cannot be built (no ``g++``). ``parse_letor_file.parses`` counts the
files the native parser read, so a caller can tell which parser ran.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ultra_pytorch_tpu_torch.ops.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "letor_parser.cpp"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
ID_BYTES = 48   # an id longer than ID_BYTES - 1 bytes is cut there

FORMAT_LIBSVM = 0   # label qid:X idx:val ...
FORMAT_ULTRA = 1    # did idx:val ...

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The parser's library, built on first use; None when there is no
    ``g++`` or the build fails."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        try:
            built = build.build_library("letor_parser", [SOURCE], gxx,
                                        GXX_FLAGS)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
        lib = ctypes.CDLL(str(built.path))
        lib.letor_count.restype = ctypes.c_int64
        lib.letor_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
        lib.letor_parse.restype = ctypes.c_int64
        lib.letor_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p, ctypes.c_int64]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def parse_letor_file(path: str, fmt: int,
                     feature_size: Optional[int] = None
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, List[str]]]:
    """Parse a LETOR text file natively.

    Args:
      path: file path.
      fmt: FORMAT_LIBSVM or FORMAT_ULTRA.
      feature_size: dense width; the file's largest index when None.

    Returns:
      (features [rows, feature_size] float32, labels [rows] float32 (zeros
      for FORMAT_ULTRA), ids (qids for libsvm, dids for ULTRA)), or None
      when the library is unavailable or the file cannot be read.
    """
    lib = get_lib()
    if lib is None:
        return None
    max_feat = ctypes.c_int64(0)
    rows = lib.letor_count(path.encode(), fmt, ctypes.byref(max_feat))
    if rows < 0:
        return None
    n_feat = int(feature_size or max_feat.value)
    features = np.zeros((rows, n_feat), dtype=np.float32)
    labels = np.zeros((rows,), dtype=np.float32)
    ids = np.zeros((rows, ID_BYTES), dtype=np.uint8)
    got = lib.letor_parse(
        path.encode(), fmt, n_feat,
        features.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.c_char_p), ID_BYTES)
    if got != rows:
        return None
    parse_letor_file.parses += 1
    # Fixed-width bytes drop their trailing NULs.
    id_list = [s.decode() for s in ids.view(f"S{ID_BYTES}")[:, 0]]
    return features, labels, id_list


parse_letor_file.parses = 0
