"""Native host runtime: ``ctypes`` bindings to the port's copy of the C++
message-level engine and PvL wire codec (``src/qba_native.cc``).

The library is built at first use with ``g++ -O2 -std=c++17 -Wall
-Wextra -fPIC -shared -pthread`` (no dependencies) into
:func:`qba_tpu_torch.ops._build.build_dir`, named by a hash of the
source and the flags, so an edited source rebuilds.  It never loads the
JAX package's library.  A build that cannot run or fails raises
:class:`NativeUnavailableError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "qba_native.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared",
             "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


class NativeUnavailableError(RuntimeError):
    """The native library could not be built (no C++ compiler, or a
    compile failure): a type of its own so the CLI reports exactly this
    condition while other errors keep their tracebacks."""


def library_path() -> Path:
    """Where the built library lies: the build directory, named by the
    hash of the source and the flags."""
    from qba_tpu_torch.ops._build import build_dir

    h = hashlib.sha256("\0".join(CXX_FLAGS).encode() + b"\0"
                       + SRC.read_bytes())
    return build_dir() / f"qba_native-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeUnavailableError(
            "native build failed: no C++ compiler (g++ not found)")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
    except OSError as e:
        raise NativeUnavailableError(f"native build failed: {e}") from e
    if proc.returncode != 0:
        raise NativeUnavailableError(
            f"native build failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, target)


def load() -> ctypes.CDLL:
    """Build (if not built) and load the library; thread-safe, cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.qba_consistent.restype = ctypes.c_int
        lib.qba_consistent.argtypes = [
            ctypes.c_int32, _i32p, _i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int32,
        ]
        lib.qba_encode_pvl.restype = ctypes.c_int
        lib.qba_encode_pvl.argtypes = [
            _i32p, ctypes.c_int, ctypes.c_int32, _i32p, _i32p, ctypes.c_int,
            ctypes.c_int, _i32p, ctypes.c_int,
        ]
        lib.qba_decode_pvl.restype = ctypes.c_int
        lib.qba_decode_pvl.argtypes = [
            _i32p, ctypes.c_int, _i32p, ctypes.c_int, _i32p, _i32p,
            ctypes.c_int, ctypes.c_int, _i32p,
        ]
        lib.qba_run_trial.restype = ctypes.c_int
        lib.qba_run_trial.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
            ctypes.c_int, ctypes.c_int, _u8p, _i32p, _i32p, ctypes.c_int32,
            _u8p, _u8p, _u8p, _i32p, _u8p, _i32p, _i32p, ctypes.c_int32,
            _i32p,
        ]
        lib.qba_run_trials.restype = ctypes.c_int
        lib.qba_run_trials.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int32, ctypes.c_int, ctypes.c_int, _u8p,
            _i32p, _i32p, _i32p, _u8p, _u8p, _u8p, _i32p, _u8p, _i32p,
        ]
        _lib = lib
        return _lib
