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
its control bits, its param index and its 2x2 entries, and a pass
table, which groups the ops for the kernel's route.  Every gate is the
same pair update of ``state[i]`` and ``state[i | bit]`` over the
indices with the target bit clear and all control bits set.
:func:`circuit_route` picks the kernel's route from the state's width
alone: one block's shared memory, a thread-block cluster's, or global
memory.

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
# A pass applies consecutive in-block ops whose targets lie in at most
# this many bits together (1 to 3), in registers
# (``csrc/fused_circuit.cu``).
PASS_BITS = 3
# The state one block keeps in shared memory (``kSmemState``); on the
# cluster route, the state a cluster's block holds where the cluster is
# not at its largest, and the largest cluster a run takes (16, past the
# portable 8): 16 blocks of 64 KB hold 18 qubits real or 17 complex, 16
# of 128 KB 19 real or 18 complex.
BLOCK_STATE_BYTES = 128 * 1024
CLUSTER_BLOCK_BYTES = 64 * 1024
CLUSTER_MAX = 16


def circuit_route(n_qubits: int, planes: int) -> tuple[str, int, int]:
    """``(route, cluster, local_bits)`` of the kernel for a state of
    ``n_qubits`` and ``planes`` float32 planes (1 real, 2 complex): a
    function of the width alone.

    * ``"block"``: the state fits :data:`BLOCK_STATE_BYTES`; one block a
      run holds it in shared memory (cluster 1, every bit local).
    * ``"cluster"``: ``cluster`` blocks hold it, each the
      ``2**local_bits`` amplitudes of its rank (the high flat bits):
      blocks of :data:`CLUSTER_BLOCK_BYTES` up to :data:`CLUSTER_MAX`
      blocks, then :data:`CLUSTER_MAX` blocks of up to
      :data:`BLOCK_STATE_BYTES`.
    * ``"global"``: wider states stay in global memory (cluster 0, every
      bit local).
    """
    state = (4 * planes) << n_qubits
    if state <= BLOCK_STATE_BYTES:
        return "block", 1, n_qubits
    cluster = min(-(-state // CLUSTER_BLOCK_BYTES), CLUSTER_MAX)
    if state // cluster <= BLOCK_STATE_BYTES:
        return "cluster", cluster, n_qubits - (cluster.bit_length() - 1)
    return "global", 0, n_qubits


@dataclasses.dataclass(frozen=True)
class CircuitTables:
    """A circuit as the kernel reads it (CPU tensors; :meth:`to` moves
    them).  ``ops_i`` int32 ``[n_ops, 4]`` = (kind, target bit, control
    mask, param index or -1); ``ops_f`` float32 ``[n_ops, 8]`` = the 2x2
    entries (m00, m01, m10, m11) as (real, imag) pairs.  ``passes`` int32
    ``[n_pass, 3]`` = (first op, ops, mask of their target bits), each
    op's class on ``route`` (:func:`circuit_route`'s): runs of
    consecutive ops whose targets are local bits of a block and lie in
    at most :data:`PASS_BITS` bits together, and each op whose target
    is a rank bit of the cluster route (an exchange between two blocks)
    alone, with mask 0."""

    n_qubits: int
    n_params: int
    is_real: bool
    ops_i: torch.Tensor
    ops_f: torch.Tensor
    passes: torch.Tensor
    route: tuple[str, int, int]

    def to(self, device) -> "CircuitTables":
        return dataclasses.replace(
            self, ops_i=self.ops_i.to(device), ops_f=self.ops_f.to(device),
            passes=self.passes.to(device))


def _passes(rows_i, local_bits: int) -> list[list[int]]:
    """The op table's passes, ``[first op, ops, target mask]``, for a route
    with ``local_bits`` local bits."""
    if not 1 <= PASS_BITS <= 3:
        raise ValueError(f"a pass spans 1 to 3 bits; PASS_BITS={PASS_BITS}")
    out = []
    for k, (_kind, bit, _ctrl, _pi) in enumerate(rows_i):
        mask = out[-1][2] | 1 << bit if out else 0
        if bit >= local_bits:
            out.append([k, 1, 0])
        elif out and out[-1][2] and bin(mask).count("1") <= PASS_BITS:
            out[-1][1] += 1
            out[-1][2] = mask
        else:
            out.append([k, 1, 1 << bit])
    return out


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
    route = circuit_route(n_qubits, 1 if is_real else 2)
    return CircuitTables(
        n_qubits=n_qubits, n_params=max(n_params, 1), is_real=is_real,
        ops_i=torch.tensor(rows_i, dtype=torch.int32).reshape(-1, 4),
        ops_f=torch.from_numpy(
            # qba-lint: sync-ok (host lists: the tables are built on the host)
            np.asarray(rows_f, np.float32).reshape(-1, 8)),
        passes=torch.tensor(_passes(rows_i, route[2]),
                            dtype=torch.int32).reshape(-1, 3),
        route=route,
    )


def _as_output(tables: CircuitTables, planes: torch.Tensor) -> torch.Tensor:
    """``[B, planes, 2**n]`` float32 -> float32 ``[B, 2**n]`` (real) or
    complex64 from the (real, imag) pair."""
    if tables.is_real:
        return planes[:, 0]
    return torch.complex(planes[:, 0], planes[:, 1])


def _pair_update(kind, m, x0, x1, y0, y1):
    """New values of the pairs ``(x0, x1)`` (imaginary planes ``y0, y1``,
    ``None`` for a real state) under one gate: the kernel's arithmetic
    (``apply_pair``), in its order."""
    ny0 = ny1 = None
    if kind == KIND_H:
        nx0, nx1 = (x0 + x1) * INV_SQRT2, (x0 - x1) * INV_SQRT2
        if y0 is not None:
            ny0, ny1 = (y0 + y1) * INV_SQRT2, (y0 - y1) * INV_SQRT2
    elif kind in (KIND_X, KIND_XPOW):
        nx0, nx1, ny0, ny1 = x1, x0, y1, y0
    elif y0 is None:
        nx0 = m[0] * x0 + m[2] * x1
        nx1 = m[6] * x1 + m[4] * x0
    else:
        nx0 = m[0] * x0 - m[1] * y0 + m[2] * x1 - m[3] * y1
        ny0 = m[1] * x0 + m[0] * y0 + m[3] * x1 + m[2] * y1
        nx1 = m[6] * x1 - m[7] * y1 + m[4] * x0 - m[5] * y0
        ny1 = m[7] * x1 + m[6] * y1 + m[5] * x0 + m[4] * y0
    return nx0, nx1, ny0, ny1


def _local_ops(kind, m, on, planes, lo):
    """A gate on bit ``log2(lo)`` of each row of ``planes`` (``[x, y]`` or
    ``[x]``, ``[R, size]``), applied where ``on`` ``[R or 1, hi, lo]``
    holds: the pairs ``(i, i | lo)`` as ``[R, hi, 2, lo]``."""
    halves = [p.reshape(p.shape[0], -1, 2, lo) for p in planes]
    x0, x1 = halves[0][:, :, 0], halves[0][:, :, 1]
    y0, y1 = ((halves[1][:, :, 0], halves[1][:, :, 1]) if len(planes) > 1
              else (None, None))
    new = _pair_update(kind, m, x0, x1, y0, y1)
    out = []
    for i, h in enumerate(halves):
        n0, n1 = new[2 * i], new[2 * i + 1]
        out.append(torch.stack(
            [torch.where(on, n0, h[:, :, 0]), torch.where(on, n1, h[:, :, 1])],
            dim=2).reshape(planes[i].shape))
    return out


def fused_circuit_reference(tables: CircuitTables,
                            params: torch.Tensor) -> torch.Tensor:
    """The circuit of ``tables`` for every row of ``params`` int32 ``[B,
    n_params]`` in plain PyTorch: the kernel's pair updates, op by op, on
    float32 (real, imag) planes."""
    size = 1 << tables.n_qubits
    n_runs = params.shape[0]
    dev = params.device
    x = torch.zeros((n_runs, size), dtype=torch.float32, device=dev)
    x[:, 0] = 1.0
    planes = [x] if tables.is_real else [x, torch.zeros_like(x)]
    index = torch.arange(size, device=dev)
    ops_f = tables.ops_f.to(dev)
    # qba-lint: sync-ok (plain version: CPU tensors only)
    for (kind, bit, ctrl, pi), m in zip(tables.ops_i.tolist(), ops_f):
        lo = 1 << bit
        # A pair takes part when every control bit of i is set.
        on = ((index & ctrl) == ctrl).reshape(-1, 2, lo)[:, 0]
        if kind == KIND_XPOW:
            on = on & (params[:, pi] != 0)[:, None, None]
        planes = _local_ops(kind, m, on, planes, lo)
    return _as_output(tables, torch.stack(planes, dim=1))


def cluster_split_reference(tables: CircuitTables, params: torch.Tensor,
                            cluster: int) -> torch.Tensor:
    """The cluster route's algorithm in plain PyTorch, for ``cluster``
    blocks a run at any width: block ``b`` holds the amplitudes whose high
    ``log2(cluster)`` flat bits are ``b``.  A gate on a local bit updates
    each block's pairs, the block taking part only where its rank has the
    control bits on rank bits set; a gate on a rank bit pairs each block
    whose rank has that bit clear with its partner, the lower block
    updating the pairs of the lower half of the local indices in both
    blocks and the partner those of the upper half.  The same arithmetic
    as :func:`fused_circuit_reference`, so the results are equal; the
    split is the kernel's (``csrc/fused_circuit.cu``)."""
    n, n_runs, dev = tables.n_qubits, params.shape[0], params.device
    c = cluster.bit_length() - 1
    if cluster != 1 << c or not 0 < c < n:
        raise ValueError(f"a cluster of {cluster} blocks cannot split "
                         f"{n} qubits")
    local = n - c
    nl, lmask = 1 << local, (1 << local) - 1
    x = torch.zeros((n_runs, cluster, nl), dtype=torch.float32, device=dev)
    x[:, 0, 0] = 1.0
    planes = [x] if tables.is_real else [x, torch.zeros_like(x)]
    index = torch.arange(nl, device=dev)
    rank = torch.arange(cluster, device=dev)
    ops_f = tables.ops_f.to(dev)
    # qba-lint: sync-ok (plain version: CPU tensors only)
    for (kind, bit, ctrl, pi), m in zip(tables.ops_i.tolist(), ops_f):
        ctrl_local, ctrl_rank = ctrl & lmask, ctrl >> local
        run_on = (params[:, pi] != 0 if kind == KIND_XPOW
                  else torch.ones(n_runs, dtype=torch.bool, device=dev))
        block_on = (rank & ctrl_rank) == ctrl_rank                   # [C]
        if bit < local:
            lo = 1 << bit
            on = ((index & ctrl_local) == ctrl_local).reshape(-1, 2, lo)[:, 0]
            on = (on[None] & run_on[:, None, None, None]
                  & block_on[None, :, None, None]).reshape(-1, *on.shape)
            planes = [p.reshape(n_runs, cluster, nl) for p in _local_ops(
                kind, m, on, [p.reshape(-1, nl) for p in planes], lo)]
            continue
        tb = 1 << (bit - local)
        # qba-lint: sync-ok (plain version: CPU tensors only)
        lower = rank[(rank & tb) == 0]
        upper = lower | tb
        half = nl // 2
        idx_on = (index & ctrl_local) == ctrl_local                  # [NL]
        new = [p.clone() for p in planes]
        for part in (slice(0, half), slice(half, nl)):
            on = (run_on[:, None, None] & block_on[lower][None, :, None]
                  & idx_on[part][None, None])
            x0, x1 = planes[0][:, lower, part], planes[0][:, upper, part]
            y0, y1 = ((planes[1][:, lower, part], planes[1][:, upper, part])
                      if len(planes) > 1 else (None, None))
            upd = _pair_update(kind, m, x0, x1, y0, y1)
            for i, p in enumerate(new):
                p[:, lower, part] = torch.where(on, upd[2 * i],
                                                planes[i][:, lower, part])
                p[:, upper, part] = torch.where(on, upd[2 * i + 1],
                                                planes[i][:, upper, part])
        planes = new
    return _as_output(tables, torch.stack(
        [p.reshape(n_runs, -1) for p in planes], dim=1))


def fused_circuit(tables: CircuitTables, params: torch.Tensor) -> torch.Tensor:
    """Statevectors ``[B, 2**n]`` of the circuit of ``tables`` for every
    row of ``params`` int32 ``[B, n_params]``.

    CPU tensors run :func:`fused_circuit_reference`.  CUDA tensors launch
    the CUDA kernel on ``tables.route`` (a block or a cluster of blocks
    a run), with ``tables`` on the same device; ``params`` must be int32,
    contiguous and ``[B, tables.n_params]``.  Any other input raises.
    """
    if not dispatch("fused_circuit", (params,)):
        return fused_circuit_reference(tables, params)
    dev = params.device
    n_runs = params.shape[0]
    n_ops = tables.ops_i.shape[0]
    check("params", params, torch.int32, (n_runs, tables.n_params), dev)
    check("ops_i", tables.ops_i, torch.int32, (n_ops, 4), dev)
    check("ops_f", tables.ops_f, torch.float32, (n_ops, 8), dev)
    n_pass = tables.passes.shape[0]
    check("passes", tables.passes, torch.int32, (n_pass, 3), dev)
    n_planes = 1 if tables.is_real else 2
    out = torch.empty((n_runs, n_planes, 1 << tables.n_qubits),
                      dtype=torch.float32, device=dev)
    fn = kernel_fn("fused_circuit", "qba_fused_circuit", 5, 7)
    args = ptrs(tables.ops_i, tables.ops_f, tables.passes, params, out)
    args += [n_runs, tables.n_qubits, n_ops, n_pass, tables.n_params,
             n_planes, tables.route[1]]
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
