"""Build the port's CUDA kernels from the sources in ``ops/csrc`` and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``<build_dir()>/<name>-<key>.so`` at first use.  The build key hashes
the ``.cu`` source, every ``csrc`` header it includes (directly or
through another header) and the kernel's ``nvcc`` flags (``flags``), so
an edit to a shared header rebuilds every kernel that includes it.  :func:`build_dir` is
``build/qba_tpu_torch`` at the root of a checkout (the directory
``.gitignore`` lists) and a per-user cache directory for an installed
package.  There is no fallback: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("fused_round", "trial_megakernel", "tiled_round", "round_step",
           "fused_circuit", "gf2_sweep", "ring_shuffle", "attack_draws",
           "sweep_loop", "surface_loop", "setup_trial")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Flags of one kernel, in its build key: the trial megakernel's fifteen
# instantiations are optimised in parallel (nvcc's split compilation)
# rather than one after another; the surface loop's float arithmetic
# rounds every operation on its own, as its plain PyTorch version does
# (no contraction into fused multiply-adds).
KERNEL_FLAGS = {"trial_megakernel": ("-split-compile=0",),
                "surface_loop": ("-fmad=false",)}
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel library that could not be built (no ``nvcc``, or a
    compiler error)."""


def build_dir() -> Path:
    """Where built libraries go: ``build/qba_tpu_torch`` at the root of
    the checkout the package sits in (a directory holding
    ``pyproject.toml`` beside the package), else
    ``$XDG_CACHE_HOME/qba_tpu_torch`` (default ``~/.cache``)."""
    package = CSRC.parents[1]
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / package.name
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / package.name


def nvcc() -> str:
    """Path of ``nvcc``; raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels cannot be built")
    return found


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` file it includes, in first-
    include order."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (CSRC / inc).is_file():
                todo.append(CSRC / inc)
    return seen


def flags(name: str) -> tuple[str, ...]:
    """The ``nvcc`` flags of kernel ``name``."""
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def _target(name: str) -> tuple[Path, Path]:
    """``(source, library)``: the library's name carries the build key."""
    h = hashlib.sha256("\0".join(flags(name)).encode())
    for path in sources(name):
        h.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    return CSRC / f"{name}.cu", build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists: returns
    ``(process or None, target, temp path)``."""
    src, lib = _target(name)
    if lib.is_file():
        return None, lib, None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(src)]
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
        raise KernelBuildError("CUDA kernel build failed: "
                               + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)[1]))
        _loaded[name] = lib
    return lib


def loaded_libraries() -> list[str]:
    """The kernels whose libraries this process has loaded."""
    return sorted(_loaded)
