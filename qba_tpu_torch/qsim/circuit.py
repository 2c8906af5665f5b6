"""Circuits and composite gates — counterpart of :mod:`qba_tpu.qsim.circuit`.

A :class:`Circuit` is a static op list.  Its compiled functions are
batched: one circuit run per key (and per row of runtime params), where
the JAX package vmaps a one-run function.  Data-dependent gates are
parameterized ``XPOW`` ops reading a runtime param vector, so one program
serves every list position and trial.

``impl`` picks the executor: ``"xla"`` is the plain per-gate PyTorch
engine (complex64, :mod:`qba_tpu_torch.qsim.statevector`); ``"pallas"``
is the fused circuit kernel (:mod:`qba_tpu_torch.ops.fused_circuit`;
float32 for all-real circuits; CPU tensors run its plain version);
``"stabilizer"`` is the Clifford tableau: :meth:`Circuit.compile` runs
the per-shot engine (:mod:`qba_tpu_torch.qsim.stabilizer`),
:meth:`Circuit.compile_shots` the batched GF(2) engine
(:mod:`qba_tpu_torch.gf2.symplectic`, whose sweep is a kernel on CUDA).
``"auto"`` is ``"pallas"`` on CUDA and ``"xla"`` on the CPU up to
:data:`~qba_tpu_torch.config.DENSE_QUBIT_CAP` qubits, and
``"stabilizer"`` past it for a Clifford op list.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from qba_tpu_torch.config import DENSE_QUBIT_CAP
from qba_tpu_torch.qsim import statevector as sv

FIXED_GATES = ("H", "X", "Y", "Z", "S", "T")
ROTATION_GATES = ("RX", "RY", "RZ", "P")


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

    def resolve_auto_impl(self, device=None) -> str:
        """``impl="auto"`` at or under :data:`DENSE_QUBIT_CAP` qubits:
        the fused circuit kernel for a CUDA device, the plain engine for
        the CPU (``device=None`` means CUDA).  Past the cap no statevector can exist, so a Clifford op
        list goes to the stabilizer tableau engine with a
        :class:`~qba_tpu_torch.diagnostics.QBADemotionWarning`, whatever
        the device; any other op list raises ``ValueError``."""
        if self.n_qubits <= DENSE_QUBIT_CAP:
            dev = torch.device("cuda" if device is None else device)
            return "pallas" if dev.type == "cuda" else "xla"
        from qba_tpu_torch.qsim.stabilizer import is_clifford_ops

        if is_clifford_ops(self.ops):
            from qba_tpu_torch.diagnostics import QBADemotionWarning

            warnings.warn(
                f"{self.n_qubits}-qubit circuit exceeds the dense cap "
                f"({DENSE_QUBIT_CAP}); op list is Clifford — routing "
                "impl='auto' to the stabilizer tableau engine",
                QBADemotionWarning, stacklevel=3,
            )
            return "stabilizer"
        raise ValueError(
            f"{self.n_qubits}-qubit circuit exceeds the dense cap "
            f"({DENSE_QUBIT_CAP} qubits) and is outside the stabilizer "
            "engine's Clifford gate set — no executor can run it"
        )

    def _resolve(self, impl: str, device) -> str:
        if impl == "auto":
            impl = self.resolve_auto_impl(device)
        if impl not in ("xla", "pallas", "stabilizer"):
            raise ValueError(f"unknown circuit impl {impl!r}")
        return impl

    def _stabilizer(self, impl: str) -> bool:
        """Whether ``impl`` runs on the tableau engines: ``"stabilizer"``,
        or ``"auto"`` past the dense cap (which resolves the same on
        every device)."""
        if impl == "auto" and self.n_qubits > DENSE_QUBIT_CAP:
            impl = self.resolve_auto_impl()
        return impl == "stabilizer"

    def compile_state(self, impl: str = "xla", device=None):
        """Build ``state(params=None) -> flat statevectors``.

        ``params`` int ``[B, n_params]`` gives ``[B, 2**n]`` on the
        params' device; ``params=None`` means all-zero params (every
        ``X**b`` the identity) and gives one state ``[2**n]`` on
        ``device`` (default: CUDA).  ``"xla"`` returns complex64;
        ``"pallas"`` float32 when every gate is real, complex64
        otherwise.  The function's ``place()`` copies the constants it
        reads (gate matrices, the kernel's tables) to ``device`` now;
        the first call does it otherwise."""
        dev = torch.device("cuda" if device is None else device)
        impl = self._resolve(impl, dev)
        ops, n, n_params = tuple(self.ops), self.n_qubits, self.n_params
        if impl == "stabilizer":
            raise ValueError(
                "the stabilizer engine has no statevector (that is the "
                "point: it runs circuits whose 2**n amplitudes cannot "
                "exist); use compile()/compile_shots(impl='stabilizer')"
            )
        if impl == "pallas":
            from qba_tpu_torch.ops.fused_circuit import build_fused_circuit_run

            run = build_fused_circuit_run(n, ops, n_params)

            def pallas_fn(params: torch.Tensor | None = None) -> torch.Tensor:
                return run(params, device=dev)

            pallas_fn.place = lambda: run.place(dev)
            return pallas_fn

        # Each static gate's matrix on the device, copied at the first
        # call (or by ``place``): a call after it copies nothing from
        # the host, so a CUDA graph can capture it.
        mats: list = []

        def place() -> None:
            if not mats:
                sv._as_matrix(sv.I2, dev)  # the two that X**b blends
                sv._as_matrix(sv.X, dev)
                mats.extend(None if op.kind == "XPOW" else sv._as_matrix(
                    sv.gate_matrix(op.kind, op.angle), dev) for op in ops)

        def state_fn(params: torch.Tensor | None = None) -> torch.Tensor:
            single = params is None
            if single:
                params = torch.zeros((1, max(n_params, 1)), dtype=torch.int32,
                                     device=dev)
            place()
            state = sv.init_state(n, params.shape[0], params.device)
            for op, mat in zip(ops, mats):
                if op.kind == "XPOW":
                    mat = sv.xpow_matrix(params[:, op.param])
                state = sv.apply_controlled_1q(state, mat, op.target,
                                               op.controls)
            flat = state.reshape(params.shape[0], -1)
            return flat[0] if single else flat

        state_fn.place = place
        return state_fn

    def compile(self, impl: str = "xla", p_depolarize: float = 0.0,
                p_measure_flip: float = 0.0):
        """Build ``run(keys, params=None) -> int32 bits [K, n_qubits]``
        for keys ``[K, 2]``: one Born sample of the final state per key.
        ``params`` int ``[K, n_params]`` gives each key its own run;
        ``params=None`` prepares the all-zero-params state once for all
        keys.  Runs on the keys' device.  Nonzero noise applies the exact
        classical reduction of :mod:`qba_tpu_torch.qsim.noise` to the
        measured bits, off each key's noise fork.

        ``impl="stabilizer"`` (and ``"auto"`` past the dense cap) runs the
        per-shot tableau engine instead, same contract, any width, noise
        as a tableau phase edit."""
        n = self.n_qubits
        if self._stabilizer(impl):
            from qba_tpu_torch.qsim.stabilizer import build_tableau_run

            return build_tableau_run(n, tuple(self.ops), self.n_params,
                                     p_depolarize, p_measure_flip)
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
        batches over shots.  ``impl="stabilizer"`` (and ``"auto"`` past
        the dense cap) runs the whole shot batch on the batched GF(2)
        engine, bit-identical to the per-shot engine under the same
        keys."""
        n = self.n_qubits
        if self._stabilizer(impl):
            from qba_tpu_torch.gf2 import build_gf2_tableau_run_shots

            return build_gf2_tableau_run_shots(
                n, tuple(self.ops), self.n_params, p_depolarize,
                p_measure_flip)
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
