"""The port's kernel build: its key, its directory and its sources.

The key of a built library hashes the ``.cu`` source, every ``csrc``
header it includes and the kernel's ``nvcc`` flags, so a header edit
rebuilds.
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


def test_kernel_flags_are_in_that_kernels_key_only(csrc, monkeypatch):
    # A kernel's own flags (the megakernel's split compilation) enter its
    # build key and command line, and no other kernel's.
    (csrc / "other.cu").write_text("int k();\n")
    before = {k: _build._target(k)[1] for k in ("kern", "other")}
    monkeypatch.setattr(_build, "KERNEL_FLAGS", {"kern": ("-G",)})
    assert _build.flags("kern") == _build.NVCC_FLAGS + ("-G",)
    assert _build.flags("other") == _build.NVCC_FLAGS
    assert _build._target("kern")[1] != before["kern"]
    assert _build._target("other")[1] == before["other"]


def test_megakernel_compiles_split():
    assert "-split-compile=0" in _build.flags("trial_megakernel")
    assert all("-split-compile=0" not in _build.flags(k)
               for k in _build.KERNELS if k != "trial_megakernel")


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
    # header (so its edits rebuild them), the circuit, ring, sweep-loop and
    # surface-loop kernels stand alone, the sweep's header is in the sweep kernel and
    # the megakernel, and the draws' header in the draws kernel, the
    # megakernel and the set-up kernel.
    assert set(_build.KERNELS) == {"fused_round", "trial_megakernel",
                                   "tiled_round", "round_step",
                                   "fused_circuit", "gf2_sweep",
                                   "ring_shuffle", "attack_draws",
                                   "sweep_loop", "surface_loop",
                                   "setup_trial"}
    for name in _build.KERNELS:
        files = [p.name for p in _build.sources(name)]
        assert files[0] == f"{name}.cu"
        assert ("round_common.cuh" in files) == (
            name not in ("fused_circuit", "gf2_sweep", "ring_shuffle",
                         "attack_draws", "sweep_loop", "surface_loop",
                         "setup_trial"))
        assert ("gf2_sweep.cuh" in files) == (
            name in ("gf2_sweep", "trial_megakernel"))
        assert ("draws.cuh" in files) == (
            name in ("attack_draws", "trial_megakernel", "setup_trial"))
    assert _build.build_dir().parts[-2:] == ("build", "qba_tpu_torch")


@pytest.mark.parametrize("name", ["round_step", "fused_circuit", "gf2_sweep",
                                  "ring_shuffle", "trial_megakernel",
                                  "attack_draws", "sweep_loop",
                                  "surface_loop", "setup_trial"])
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
            "ops/csrc/round_step.cu", "ops/csrc/fused_circuit.cu",
            "ops/csrc/ring_shuffle.cu"} <= set(files)
    for f in files:
        assert any(fnmatch.fnmatch(f, g) for g in globs), f


def test_draws_header_edit_rebuilds_its_kernels(tmp_path, monkeypatch):
    # An edit to draws.cuh changes the draws kernel's, the megakernel's
    # and the set-up kernel's build keys, and no other kernel's.
    import shutil

    before = {name: _build._target(name)[1].name for name in _build.KERNELS}
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    with open(copy / "draws.cuh", "a") as f:
        f.write("// edit\n")
    changed = {name for name in _build.KERNELS
               if _build._target(name)[1].name != before[name]}
    assert changed == {"attack_draws", "trial_megakernel", "setup_trial"}


def test_round_header_edit_rebuilds_its_kernels(tmp_path, monkeypatch):
    # round_common.cuh holds the per-round kernels' phases and the helpers
    # the megakernel's header shares (lane groups, cp.async, the phase
    # clock): an edit there changes the build keys of the three per-round
    # sources and the megakernel, and no other kernel's.
    import shutil

    before = {name: _build._target(name)[1].name for name in _build.KERNELS}
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    with open(copy / "round_common.cuh", "a") as f:
        f.write("// edit\n")
    changed = {name for name in _build.KERNELS
               if _build._target(name)[1].name != before[name]}
    assert changed == {"fused_round", "tiled_round", "round_step",
                       "trial_megakernel"}
