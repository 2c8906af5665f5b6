"""A whole statevector circuit in one launch — counterpart of
:mod:`qba_tpu.ops.fused_circuit`.

:func:`build_fused_circuit_run` turns a static op list into ``run(params)
-> statevectors``: one circuit run per row of ``params`` ``[B,
n_params]`` (the runtime 0/1 bits the ``XPOW`` gates read), each starting
from |0...0>.  The result is float32 ``[B, 2**n]`` when every gate is
real-valued (the protocol circuits: H, X, CNOT, ``X**b``) and complex64,
from a (real, imag) pair of float32 planes, otherwise.

The TPU kernel is traced once per circuit; here one compiled CUDA kernel
(``csrc/fused_circuit.cu``) serves every circuit and takes the op list as
a small table: per op its kind, the flat-index bit of its target (qubit
``q`` is bit ``n - 1 - q``: qubit 0 is the most significant), the mask of
its control bits, its param index, and its 2x2 entries.  Every gate is
the same pair update of ``state[i]`` and ``state[i | bit]`` over the
indices with the target bit clear and all control bits set.

:func:`fused_circuit` launches the kernel for CUDA tensors and runs
:func:`fused_circuit_reference`, the same pair updates in plain PyTorch,
for CPU tensors; a CUDA tensor never reaches the plain version.  The two
apply the same float32 arithmetic in the same order, but the CUDA
compiler may contract a multiply and an add into one fused multiply-add,
so they are held together at ``atol=1e-6`` on amplitudes, not bit for
bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qba_tpu_torch.config import DENSE_QUBIT_CAP
from qba_tpu_torch.ops._launch import (
    check,
    dispatch,
    kernel_fn,
    ptrs,
    timed_launch,
)

KIND_H, KIND_X, KIND_XPOW, KIND_GEN = 0, 1, 2, 3
INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))


@dataclasses.dataclass(frozen=True)
class CircuitTables:
    """A circuit as the kernel reads it (CPU tensors; :meth:`to` moves
    them).  ``ops_i`` int32 ``[n_ops, 4]`` = (kind, target bit, control
    mask, param index or -1); ``ops_f`` float32 ``[n_ops, 8]`` = the 2x2
    entries (m00, m01, m10, m11) as (real, imag) pairs."""

    n_qubits: int
    n_params: int
    is_real: bool
    ops_i: torch.Tensor
    ops_f: torch.Tensor

    def to(self, device) -> "CircuitTables":
        return dataclasses.replace(
            self, ops_i=self.ops_i.to(device), ops_f=self.ops_f.to(device))


def circuit_tables(n_qubits: int, ops, n_params: int) -> CircuitTables:
    """The op table of ``ops`` (a sequence of
    :class:`qba_tpu_torch.qsim.circuit.Op`).  H, X and ``XPOW`` keep
    their add-only and swap forms; every other gate is a coefficient
    form over its matrix entries."""
    from qba_tpu_torch.qsim.statevector import gate_matrix

    if not 1 <= n_qubits <= DENSE_QUBIT_CAP:
        raise ValueError(
            f"the fused circuit kernel runs 1..{DENSE_QUBIT_CAP} qubits; "
            f"got {n_qubits}")
    kinds = {"H": KIND_H, "X": KIND_X, "XPOW": KIND_XPOW}
    rows_i, rows_f, is_real = [], [], True
    for op in ops:
        mask = 0
        for c in op.controls:
            mask |= 1 << (n_qubits - 1 - c)
        kind = kinds.get(op.kind, KIND_GEN)
        entries = np.zeros(8, np.float32)
        if kind == KIND_GEN:
            g2 = gate_matrix(op.kind, op.angle).reshape(-1)
            entries[0::2], entries[1::2] = g2.real, g2.imag
            is_real = is_real and not np.any(g2.imag)
        rows_i.append([kind, n_qubits - 1 - op.target, mask,
                       -1 if op.param is None else op.param])
        rows_f.append(entries)
    return CircuitTables(
        n_qubits=n_qubits, n_params=max(n_params, 1), is_real=is_real,
        ops_i=torch.tensor(rows_i, dtype=torch.int32).reshape(-1, 4),
        ops_f=torch.from_numpy(
            np.asarray(rows_f, np.float32).reshape(-1, 8)),
    )


def _as_output(tables: CircuitTables, planes: torch.Tensor) -> torch.Tensor:
    """``[B, planes, 2**n]`` float32 -> float32 ``[B, 2**n]`` (real) or
    complex64 from the (real, imag) pair."""
    if tables.is_real:
        return planes[:, 0]
    return torch.complex(planes[:, 0], planes[:, 1])


def fused_circuit_reference(tables: CircuitTables,
                            params: torch.Tensor) -> torch.Tensor:
    """The circuit of ``tables`` for every row of ``params`` int32 ``[B,
    n_params]`` in plain PyTorch: the kernel's pair updates, op by op, on
    float32 (real, imag) planes."""
    n, size = tables.n_qubits, 1 << tables.n_qubits
    n_runs = params.shape[0]
    dev = params.device
    x = torch.zeros((n_runs, size), dtype=torch.float32, device=dev)
    x[:, 0] = 1.0
    y = None if tables.is_real else torch.zeros_like(x)
    index = torch.arange(size, device=dev)
    ops_f = tables.ops_f.to(dev)
    for (kind, bit, ctrl, pi), m in zip(tables.ops_i.tolist(), ops_f):
        lo = 1 << bit
        # Pairs (i, i | bit) as [B, hi, 2, lo]; a pair takes part when
        # every control bit of i is set.
        on = ((index & ctrl) == ctrl).reshape(-1, 2, lo)[:, 0]
        if kind == KIND_XPOW:
            on = on & (params[:, pi] != 0)[:, None, None]

        def split(s):
            v = s.reshape(n_runs, -1, 2, lo)
            return v[:, :, 0], v[:, :, 1]

        x0, x1 = split(x)
        y0, y1 = split(y) if y is not None else (None, None)
        if kind == KIND_H:
            nx0, nx1 = (x0 + x1) * INV_SQRT2, (x0 - x1) * INV_SQRT2
            if y is not None:
                ny0, ny1 = (y0 + y1) * INV_SQRT2, (y0 - y1) * INV_SQRT2
        elif kind in (KIND_X, KIND_XPOW):
            nx0, nx1, ny0, ny1 = x1, x0, y1, y0
        elif y is None:
            nx0 = m[0] * x0 + m[2] * x1
            nx1 = m[6] * x1 + m[4] * x0
        else:
            nx0 = m[0] * x0 - m[1] * y0 + m[2] * x1 - m[3] * y1
            ny0 = m[1] * x0 + m[0] * y0 + m[3] * x1 + m[2] * y1
            nx1 = m[6] * x1 - m[7] * y1 + m[4] * x0 - m[5] * y0
            ny1 = m[7] * x1 + m[6] * y1 + m[5] * x0 + m[4] * y0

        def join(new0, new1, old0, old1):
            return torch.stack(
                [torch.where(on, new0, old0), torch.where(on, new1, old1)],
                dim=2).reshape(n_runs, size)

        x = join(nx0, nx1, x0, x1)
        if y is not None:
            y = join(ny0, ny1, y0, y1)
    planes = x[:, None] if y is None else torch.stack([x, y], dim=1)
    return _as_output(tables, planes)


def fused_circuit(tables: CircuitTables, params: torch.Tensor) -> torch.Tensor:
    """Statevectors ``[B, 2**n]`` of the circuit of ``tables`` for every
    row of ``params`` int32 ``[B, n_params]``.

    CPU tensors run :func:`fused_circuit_reference`.  CUDA tensors launch
    the CUDA kernel, one thread block per run, with ``tables`` on the
    same device; ``params`` must be int32, contiguous and ``[B,
    tables.n_params]``.  Any other input raises.
    """
    if not dispatch("fused_circuit", (params,)):
        return fused_circuit_reference(tables, params)
    dev = params.device
    n_runs = params.shape[0]
    n_ops = tables.ops_i.shape[0]
    check("params", params, torch.int32, (n_runs, tables.n_params), dev)
    check("ops_i", tables.ops_i, torch.int32, (n_ops, 4), dev)
    check("ops_f", tables.ops_f, torch.float32, (n_ops, 8), dev)
    n_planes = 1 if tables.is_real else 2
    out = torch.empty((n_runs, n_planes, 1 << tables.n_qubits),
                      dtype=torch.float32, device=dev)
    fn = kernel_fn("fused_circuit", "qba_fused_circuit", 4, 5)
    args = ptrs(tables.ops_i, tables.ops_f, params, out)
    args += [n_runs, tables.n_qubits, n_ops, tables.n_params, n_planes]
    timed_launch(fused_circuit, fn, args, torch.cuda.current_stream(dev))
    return _as_output(tables, out)


fused_circuit.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
fused_circuit.events = None


def build_fused_circuit_run(n_qubits: int, ops, n_params: int):
    """``run(params=None, device=None) -> statevectors`` for a static op
    list.  ``params`` int ``[B, n_params]`` gives ``[B, 2**n]``, one run
    per row, on the params' device; ``params=None`` means all-zero
    params (every ``X**b`` the identity) and gives one flat state
    ``[2**n]`` on ``device`` (default: CUDA).  float32 when every gate is
    real, complex64 otherwise."""
    tables = circuit_tables(n_qubits, tuple(ops), n_params)
    on_device: dict[torch.device, CircuitTables] = {}

    def run(params: torch.Tensor | None = None, device=None) -> torch.Tensor:
        single = params is None
        if single:
            dev = torch.device("cuda" if device is None else device)
            params = torch.zeros((1, tables.n_params), dtype=torch.int32,
                                 device=dev)
        params = params.to(torch.int32).contiguous()
        dev = params.device
        if dev not in on_device:
            on_device[dev] = tables.to(dev)
        out = fused_circuit(on_device[dev], params)
        return out[0] if single else out

    run.tables = tables
    return run
