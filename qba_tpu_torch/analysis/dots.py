"""KI-3 exact-dot pass for Hopper — the counterpart of
:mod:`qba_tpu.analysis.dots`.

PyTorch has no integer matmul on CUDA, so where the port keeps a dot on
integer data it runs in a float format, and stays exact only while
every value and every partial sum fits the format's significand: 2**24
in float32 (``torch.get_float32_matmul_precision() == "highest"``),
2**11 under TF32 (``"high"``) and 2**8 under bf16 (``"medium"``, or a
bf16 tensor).  The JAX package proves its bounds by interval analysis
of jaxprs; the port has none, so the pass has two halves:

* **Static** — every dot call site in ``qba_tpu_torch/`` (``@``,
  ``torch.matmul``/``mm``/``bmm``/``einsum``, ``F.linear`` and the
  methods of the same names) carries ``# qba-lint: exact-dot (<the
  bound argument>)`` within one line: the argument why its values stay
  exact, or why they are not integer data.  In ``ops/csrc/`` no
  ``mma``, ``wmma``, ``wgmma``, ``__half``, ``__nv_bfloat16`` or
  ``tf32`` appears without the same marker: the kernels' integer
  arithmetic stays off the tensor cores' reduced formats.
* **Dynamic** — over the dots one traced batch dispatched
  (:mod:`qba_tpu_torch.analysis.trace`): a float dot whose two operands
  hold whole numbers is a finding when an operand's largest magnitude
  leaves the exact range of the precision in force, or when the
  contraction length times both magnitudes (the accumulator's bound)
  leaves 2**24.  Operands that are not whole numbers (amplitudes,
  probabilities) are counted, not checked.  The marker does not demote
  a dynamic finding: the run checks the marker's argument.

Findings are tagged ``KI-3``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from qba_tpu_torch.analysis.findings import Finding, Report

ALLOW_MARKER = "qba-lint: exact-dot"

#: The largest integer each format holds exactly, by float32 matmul
#: precision and by dtype.
EXACT_MAX = {"highest": 2 ** 24, "high": 2 ** 11, "medium": 2 ** 8}
DTYPE_EXACT_MAX = {"float32": None, "float64": 2 ** 53,
                   "bfloat16": 2 ** 8, "float16": 2 ** 11}

#: The accumulator's bound: float32 partial sums.
ACC_EXACT_MAX = 2 ** 24

_DOT_FUNCS = frozenset({"matmul", "mm", "bmm", "einsum", "linear"})
_CSRC_TOKENS = re.compile(
    r"\b(mma|wmma|wgmma|__half|__nv_bfloat16|tf32)\b", re.IGNORECASE)


def _pkg_root() -> str:
    import qba_tpu_torch

    return os.path.dirname(os.path.abspath(qba_tpu_torch.__file__))


def _marked(lines: list[str], lineno: int) -> str | None:
    for i in range(max(0, lineno - 2), min(len(lines), lineno + 1)):
        if ALLOW_MARKER in lines[i]:
            return lines[i].split(ALLOW_MARKER, 1)[1].strip() or "annotated"
    return None


def dot_sites(tree: ast.Module) -> list[tuple[int, str]]:
    """``(line, form)`` of every dot call site in a module."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            out.append((node.lineno, "@"))
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _DOT_FUNCS):
            out.append((node.lineno, f".{node.func.attr}()"))
    return sorted(out)


def check_dot_sites(root: str | None = None) -> Report:
    """The static half over the package's sources (this checker's own
    modules aside) and ``ops/csrc/``."""
    root = root if root is not None else _pkg_root()
    report = Report()
    sites = marked = 0
    for dirpath, _dirs, files in os.walk(root):
        if os.path.basename(dirpath) == "analysis":
            continue
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, os.path.dirname(root))
            if fname.endswith(".py"):
                with open(path) as fh:
                    src = fh.read()
                lines = src.splitlines()
                for lineno, form in dot_sites(ast.parse(src)):
                    sites += 1
                    why = _marked(lines, lineno)
                    if why is not None:
                        marked += 1
                        report.notes.append(
                            f"dots: {form} at {rel}:{lineno}: {why}")
                        continue
                    report.findings.append(Finding(
                        ki="KI-3", check="dot-site", path=f"module:{fname}",
                        where=f"{rel}:{lineno}",
                        message=(
                            f"{form} without '# {ALLOW_MARKER} (<bound "
                            "argument>)': a float dot on integer data is "
                            "exact only while its values and partial sums "
                            "fit the format's significand — state why they "
                            "do, or why the data are not integers"
                        ),
                    ))
            elif fname.endswith((".cu", ".cuh", ".cc", ".h")):
                with open(path) as fh:
                    lines = fh.read().splitlines()
                for i, line in enumerate(lines, 1):
                    m = _CSRC_TOKENS.search(line)
                    if m and _marked(lines, i) is None:
                        report.findings.append(Finding(
                            ki="KI-3", check="dot-site",
                            path=f"csrc:{fname}", where=f"{rel}:{i}",
                            message=(
                                f"{m.group(0)} in a kernel source without "
                                f"'// {ALLOW_MARKER} (...)': the integer "
                                "kernels stay off the tensor cores' "
                                "reduced formats unless a bound says why"
                            ),
                        ))
    report.stats["dot_sites"] = sites
    report.stats["dot_sites_marked"] = marked
    return report


def _operand_bound(dtype: str, precision: str) -> int:
    bound = DTYPE_EXACT_MAX.get(dtype)
    return EXACT_MAX.get(precision, 2 ** 24) if bound is None else bound


def check_dots(records: Iterable) -> Report:
    """The dynamic half over :class:`~qba_tpu_torch.analysis.trace.
    DotRecord` s."""
    report = Report()
    checked = skipped = 0
    for rec in records:
        if rec.dtype not in DTYPE_EXACT_MAX:
            continue  # an integer or complex dot: no float rounding to check
        if not rec.integral:
            skipped += 1
            continue
        checked += 1
        bound = _operand_bound(rec.dtype, rec.precision)
        mag = max(rec.lhs_max, rec.rhs_max)
        acc = rec.k * rec.lhs_max * rec.rhs_max
        problems = []
        if mag > bound:
            problems.append(f"an operand reaches {mag:g}, past the "
                            f"{bound} a {rec.dtype} dot at precision "
                            f"{rec.precision!r} holds exactly")
        if acc > ACC_EXACT_MAX:
            problems.append(f"the accumulator's bound k x |a| x |b| = "
                            f"{rec.k} x {rec.lhs_max:g} x {rec.rhs_max:g} "
                            f"= {acc:g} passes 2**24")
        if problems:
            report.findings.append(Finding(
                ki="KI-3", check="exact-dot", path=rec.path, where=rec.where,
                message=f"{rec.op} on whole numbers: " + "; ".join(problems),
            ))
    report.stats["dots_checked"] = checked
    report.stats["dots_skipped_nonintegral"] = skipped
    return report
