"""The port's kernel build: its key, its directory and its sources.

The key of a built library hashes the ``.cu`` source, every ``csrc``
header it includes and the ``nvcc`` flags, so a header edit rebuilds.
The build directory is the checkout's ``build/`` only inside a checkout.
None of this needs ``nvcc``: the build itself runs only on the card.
"""

import pytest

pytest.importorskip("torch")

from qba_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of a kernel source and its headers in a temporary CSRC."""
    src = tmp_path / "pkg" / "ops" / "csrc"
    src.mkdir(parents=True)
    (src / "common.cuh").write_text("#pragma once\nint f();\n")
    (src / "inner.cuh").write_text('#include "common.cuh"\nint g();\n')
    (src / "kern.cu").write_text(
        '#include <cuda_runtime.h>\n#include "inner.cuh"\nint h();\n')
    monkeypatch.setattr(_build, "CSRC", src)
    return src


def test_sources_follow_includes(csrc):
    names = [p.name for p in _build.sources("kern")]
    assert names == ["kern.cu", "inner.cuh", "common.cuh"]


@pytest.mark.parametrize("edit", ["kern.cu", "inner.cuh", "common.cuh"])
def test_editing_any_included_file_changes_the_key(csrc, edit):
    src, lib = _build._target("kern")
    assert src == csrc / "kern.cu" and lib.name.startswith("kern-")
    (csrc / edit).write_text((csrc / edit).read_text() + "// edit\n")
    assert _build._target("kern")[1] != lib


def test_flags_are_in_the_key(csrc, monkeypatch):
    lib = _build._target("kern")[1]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("kern")[1] != lib


def test_unrelated_header_leaves_the_key(csrc):
    lib = _build._target("kern")[1]
    (csrc / "other.cuh").write_text("int unrelated();\n")
    assert _build._target("kern")[1] == lib


def test_build_dir_in_a_checkout(csrc):
    root = csrc.parents[2]
    (root / "pyproject.toml").write_text("[project]\nname = 'x'\n")
    assert _build.build_dir() == root / "build" / "pkg"


def test_build_dir_outside_a_checkout(csrc, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == tmp_path / "cache" / "pkg"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir() == tmp_path / "home" / ".cache" / "pkg"


def test_repo_kernels_and_their_sources():
    # Every kernel source exists; the four round kernels share the round
    # header (so its edits rebuild them), the circuit kernel stands alone,
    # and the sweep's header is in the sweep kernel and the megakernel.
    assert set(_build.KERNELS) == {"fused_round", "trial_megakernel",
                                   "tiled_round", "round_step",
                                   "fused_circuit", "gf2_sweep"}
    for name in _build.KERNELS:
        files = [p.name for p in _build.sources(name)]
        assert files[0] == f"{name}.cu"
        assert ("round_common.cuh" in files) == (
            name not in ("fused_circuit", "gf2_sweep"))
        assert ("gf2_sweep.cuh" in files) == (
            name in ("gf2_sweep", "trial_megakernel"))
    assert _build.build_dir().parts[-2:] == ("build", "qba_tpu_torch")


@pytest.mark.parametrize("name", ["round_step", "fused_circuit", "gf2_sweep"])
def test_new_sources_are_in_their_build_key(name, tmp_path, monkeypatch):
    # A copy of csrc with one byte appended to the source changes the key.
    import shutil

    lib = _build._target(name)[1]
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build._target(name)[1].name == lib.name
    with open(copy / f"{name}.cu", "a") as f:
        f.write("// edit\n")
    assert _build._target(name)[1].name != lib.name


def test_package_data_ships_every_kernel_source():
    # An installed port builds its kernels from the sources in its wheel:
    # pyproject's package data must cover every file of csrc.
    import fnmatch
    import tomllib
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    conf = tomllib.loads((root / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["qba_tpu_torch"]
    pkg = root / "qba_tpu_torch"
    files = [p.relative_to(pkg).as_posix()
             for p in (pkg / "ops" / "csrc").iterdir() if p.is_file()]
    assert {"ops/csrc/round_common.cuh", "ops/csrc/fused_round.cu",
            "ops/csrc/round_step.cu", "ops/csrc/fused_circuit.cu"} <= set(files)
    for f in files:
        assert any(fnmatch.fnmatch(f, g) for g in globs), f
