"""Build the port's CUDA kernels from the sources in ``ops/csrc`` and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/qba_tpu_torch/<name>-<hash>.so`` at the repository root (the
directory ``.gitignore`` lists), at first use, keyed by the source's
content hash.  There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("fused_round",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return CSRC.parents[2] / "build" / "qba_tpu_torch"


def nvcc() -> str:
    """Path of ``nvcc``; raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, build_dir() / f"{name}-{digest}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists: returns
    ``(process or None, target, temp path)``."""
    src, lib = _target(name)
    if lib.is_file():
        return None, lib, None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib, tmp


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel not built yet, one ``nvcc`` per source,
    all started together.  Returns each kernel's compiler log (empty when
    it was already built); raises if any build fails."""
    jobs = {name: _start(name) for name in names}
    logs, failed = {}, []
    for name, (proc, lib, tmp) in jobs.items():
        if proc is None:
            logs[name] = ""
            continue
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
        (lib.parent / f"{name}.log").write_text(out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)[1]))
        _loaded[name] = lib
    return lib
