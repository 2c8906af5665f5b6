"""Circuits and composite gates over the dense statevector engines —
counterpart of :mod:`qba_tpu.qsim.circuit`.

A :class:`Circuit` is a static op list.  Its compiled functions are
batched: one circuit run per key (and per row of runtime params), where
the JAX package vmaps a one-run function.  Data-dependent gates are
parameterized ``XPOW`` ops reading a runtime param vector, so one program
serves every list position and trial.

``impl`` picks the executor: ``"xla"`` is the plain per-gate PyTorch
engine (complex64, :mod:`qba_tpu_torch.qsim.statevector`); ``"pallas"``
is the fused circuit kernel (:mod:`qba_tpu_torch.ops.fused_circuit`;
float32 for all-real circuits; CPU tensors run its plain version);
``"auto"`` is ``"pallas"`` on CUDA and ``"xla"`` on the CPU.  The
stabilizer tableau engine, and with it every circuit past the dense cap,
is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses

import torch

from qba_tpu_torch.config import DENSE_QUBIT_CAP
from qba_tpu_torch.qsim import statevector as sv

FIXED_GATES = ("H", "X", "Y", "Z", "S", "T")
ROTATION_GATES = ("RX", "RY", "RZ", "P")


def _stabilizer_not_ported(what: str):
    return NotImplementedError(
        f"{what}: the stabilizer tableau engine is not ported yet "
        "(ROADMAP A7)")


@dataclasses.dataclass(frozen=True)
class Op:
    """One primitive operation (static description)."""

    kind: str  # one of FIXED_GATES | ROTATION_GATES | "XPOW"
    target: int
    controls: tuple[int, ...] = ()
    param: int | None = None  # index into the runtime param vector (XPOW)
    angle: float | None = None  # static angle (rotation gates only)


@dataclasses.dataclass
class Gate:
    """A named composite gate."""

    n_qubits: int
    name: str = ""
    ops: list[Op] = dataclasses.field(default_factory=list)

    def add_operation(
        self,
        kind: str,
        *,
        targets: int,
        controls: int | tuple[int, ...] | None = None,
        param: int | None = None,
        angle: float | None = None,
    ) -> "Gate":
        if kind not in (*FIXED_GATES, *ROTATION_GATES, "XPOW"):
            raise ValueError(f"unsupported gate kind {kind!r}")
        if kind == "XPOW" and param is None:
            raise ValueError("XPOW requires a param index")
        if kind in ROTATION_GATES and angle is None:
            raise ValueError(f"{kind} requires an angle")
        if kind not in ROTATION_GATES and angle is not None:
            raise ValueError(f"{kind} takes no angle")
        ctrls: tuple[int, ...]
        if controls is None:
            ctrls = ()
        elif isinstance(controls, int):
            ctrls = (controls,)
        else:
            ctrls = tuple(controls)
        for q in (targets, *ctrls):
            if not 0 <= q < self.n_qubits:
                raise ValueError(
                    f"qubit {q} out of range for {self.n_qubits}-qubit gate")
        if targets in ctrls:
            raise ValueError("target cannot also be a control")
        self.ops.append(Op(kind, targets, ctrls, param, angle))
        return self


@dataclasses.dataclass
class Circuit:
    """Gates plus an implicit measurement of every qubit."""

    n_qubits: int
    name: str = ""
    ops: list[Op] = dataclasses.field(default_factory=list)

    def add_operation(self, gate: Gate) -> "Circuit":
        if gate.n_qubits != self.n_qubits:
            raise ValueError(
                f"gate is {gate.n_qubits}-qubit, circuit is "
                f"{self.n_qubits}-qubit")
        self.ops.extend(gate.ops)
        return self

    @property
    def n_params(self) -> int:
        return max((op.param + 1 for op in self.ops if op.param is not None),
                   default=0)

    def resolve_auto_impl(self, device) -> str:
        """``impl="auto"`` at or under :data:`DENSE_QUBIT_CAP` qubits:
        the fused circuit kernel for a CUDA device, the plain engine for
        the CPU.  Past the cap no statevector can exist and the JAX
        package hands Clifford circuits to its stabilizer engine, which
        is not ported yet."""
        if self.n_qubits > DENSE_QUBIT_CAP:
            raise _stabilizer_not_ported(
                f"{self.n_qubits}-qubit circuit exceeds the dense cap "
                f"({DENSE_QUBIT_CAP})")
        return "pallas" if torch.device(device).type == "cuda" else "xla"

    def _resolve(self, impl: str, device) -> str:
        if impl == "auto":
            impl = self.resolve_auto_impl(device)
        if impl == "stabilizer":
            raise _stabilizer_not_ported("impl='stabilizer'")
        if impl not in ("xla", "pallas"):
            raise ValueError(f"unknown circuit impl {impl!r}")
        return impl

    def compile_state(self, impl: str = "xla", device=None):
        """Build ``state(params=None) -> flat statevectors``.

        ``params`` int ``[B, n_params]`` gives ``[B, 2**n]`` on the
        params' device; ``params=None`` means all-zero params (every
        ``X**b`` the identity) and gives one state ``[2**n]`` on
        ``device`` (default: CUDA).  ``"xla"`` returns complex64;
        ``"pallas"`` float32 when every gate is real, complex64
        otherwise."""
        dev = torch.device("cuda" if device is None else device)
        impl = self._resolve(impl, dev)
        ops, n, n_params = tuple(self.ops), self.n_qubits, self.n_params
        if impl == "pallas":
            from qba_tpu_torch.ops.fused_circuit import build_fused_circuit_run

            run = build_fused_circuit_run(n, ops, n_params)
            return lambda params=None: run(params, device=dev)

        def state_fn(params: torch.Tensor | None = None) -> torch.Tensor:
            single = params is None
            if single:
                params = torch.zeros((1, max(n_params, 1)), dtype=torch.int32,
                                     device=dev)
            state = sv.init_state(n, params.shape[0], params.device)
            for op in ops:
                if op.kind == "XPOW":
                    mat = sv.xpow_matrix(params[:, op.param])
                else:
                    mat = sv.gate_matrix(op.kind, op.angle)
                state = sv.apply_controlled_1q(state, mat, op.target,
                                               op.controls)
            flat = state.reshape(params.shape[0], -1)
            return flat[0] if single else flat

        return state_fn

    def compile(self, impl: str = "xla", p_depolarize: float = 0.0,
                p_measure_flip: float = 0.0):
        """Build ``run(keys, params=None) -> int32 bits [K, n_qubits]``
        for keys ``[K, 2]``: one Born sample of the final state per key.
        ``params`` int ``[K, n_params]`` gives each key its own run;
        ``params=None`` prepares the all-zero-params state once for all
        keys.  Runs on the keys' device.  Nonzero noise applies the exact
        classical reduction of :mod:`qba_tpu_torch.qsim.noise` to the
        measured bits, off each key's noise fork."""
        n = self.n_qubits
        noisy = p_depolarize > 0.0 or p_measure_flip > 0.0
        state_fns: dict = {}

        def run(keys: torch.Tensor,
                params: torch.Tensor | None = None) -> torch.Tensor:
            dev = keys.device
            if dev not in state_fns:
                state_fns[dev] = self.compile_state(impl, dev)
            state_fn = state_fns[dev]
            if params is None:
                bits = sv.measure_all(state_fn(), keys)
            else:
                # A state per key: prepare and sample a chunk at a time.
                step = max(1, sv.SAMPLE_CHUNK_ELEMS >> n)
                bits = torch.empty((keys.shape[0], n), dtype=torch.int32,
                                   device=dev)
                for a in range(0, keys.shape[0], step):
                    bits[a:a + step] = sv.measure_all(
                        state_fn(params[a:a + step]), keys[a:a + step])
            if noisy:
                from qba_tpu_torch.qsim.noise import classical_flips

                bits = bits ^ classical_flips(keys, n, p_depolarize,
                                              p_measure_flip)
            return bits

        return run

    def compile_shots(self, impl: str = "xla", p_depolarize: float = 0.0,
                      p_measure_flip: float = 0.0):
        """Build ``run(key, shots, params=None) -> int32 bits [shots,
        n_qubits]`` for one key ``[2]``: the state is prepared once
        (``params`` int ``[n_params]``) and only the Born sampling
        batches over shots."""
        n = self.n_qubits
        noisy = p_depolarize > 0.0 or p_measure_flip > 0.0

        def run(key: torch.Tensor, shots: int,
                params: torch.Tensor | None = None) -> torch.Tensor:
            state_fn = self.compile_state(impl, key.device)
            state = (state_fn() if params is None
                     else state_fn(params.to(key.device)[None])[0])
            bits = sv.measure_shots(state, key, shots)
            if noisy:
                from qba_tpu_torch.qsim.noise import classical_flips_shots

                bits = bits ^ classical_flips_shots(
                    key, shots, n, p_depolarize, p_measure_flip)
            return bits

        return run
