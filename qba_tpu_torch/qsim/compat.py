"""qsimov-shaped API shim — counterpart of :mod:`qba_tpu.qsim.compat`.

The reference drives its quantum engine through three names:
``QGate(size, 0, name)`` with ``add_operation("H"/"X", targets=,
controls=)``, ``QCircuit(size, size, name)`` with ``add_operation(gate)``
and ``add_operation("MEASURE", targets=i, outputs=i)``, and
``Drewom().execute(circ)[0] -> list[int]``.  This module provides them
with the same call shapes on the port's :class:`Circuit`.

Randomness is explicit: ``Drewom(seed=...)`` owns a threefry key and
advances it per ``execute`` call, drawing what the JAX package's
``Drewom`` draws for the same seed.  Circuits past the dense cap run on
the stabilizer tableau engine.
"""

from __future__ import annotations

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import DENSE_QUBIT_CAP
from qba_tpu_torch.qsim.circuit import Circuit, Gate


class QGate:
    """qsimov-shaped composite gate: ``QGate(size, ancilla, name)``."""

    def __init__(self, size: int, ancilla: int = 0, name: str = ""):
        if ancilla:
            raise ValueError("ancilla qubits are not supported (the "
                             "reference always passes 0)")
        self._gate = Gate(size, name)

    @property
    def name(self) -> str:
        return self._gate.name

    def add_operation(self, kind, *, targets, controls=None, outputs=None,
                      angle=None):
        if outputs is not None:
            raise ValueError("outputs= only applies to MEASURE ops on a "
                             "QCircuit")
        self._gate.add_operation(kind, targets=targets, controls=controls,
                                 angle=angle)
        return self


class QCircuit:
    """qsimov-shaped circuit: ``QCircuit(size, measured, name)``.

    ``add_operation`` accepts a :class:`QGate`, a primitive gate name, or
    ``"MEASURE"`` with ``targets=``/``outputs=``.
    """

    def __init__(self, size: int, measured: int = 0, name: str = ""):
        self._circ = Circuit(size, name)
        # outputs slot -> measured qubit; populated by MEASURE ops.
        self._outputs: dict[int, int] = {}

    @property
    def name(self) -> str:
        return self._circ.name

    @property
    def n_qubits(self) -> int:
        return self._circ.n_qubits

    def add_operation(self, op, *, targets=None, controls=None, outputs=None,
                      angle=None):
        if op == "MEASURE":
            if targets is None:
                raise ValueError("MEASURE requires targets=")
            slot = targets if outputs is None else outputs
            if slot in self._outputs:
                raise ValueError(f"output slot {slot} measured twice")
            self._outputs[slot] = targets
            return self
        # Measurement is one final Born sample: a gate after a MEASURE
        # would need mid-circuit collapse, so it is rejected.
        if self._outputs:
            raise ValueError(
                "gates after MEASURE are not supported (measurement is a "
                "single final Born sample; add all gates first)"
            )
        if isinstance(op, QGate):
            self._circ.add_operation(op._gate)
            return self
        if targets is None:
            raise ValueError(f"gate {op!r} requires targets=")
        self._circ.add_operation(
            Gate(self._circ.n_qubits).add_operation(
                op, targets=targets, controls=controls, angle=angle
            )
        )
        return self

    def _measure_order(self) -> tuple[int, ...]:
        """Measured qubits in output-slot order; default = all qubits."""
        if not self._outputs:
            return tuple(range(self._circ.n_qubits))
        return tuple(q for _, q in sorted(self._outputs.items()))


class Drewom:
    """qsimov-shaped executor: ``Drewom().execute(circuit)`` returns a
    list of shot results, each the measured bits in output-slot order.

    ``engine`` is ``"auto"`` (the plain statevector engine up to 20
    qubits, the stabilizer tableau beyond), ``"dense"`` or
    ``"stabilizer"`` (the batched GF(2) engine; non-Clifford gates raise
    ``ValueError``).  ``device=None`` means CUDA.
    """

    def __init__(self, seed: int = 0, engine: str = "auto", device=None):
        if engine not in ("auto", "dense", "stabilizer"):
            raise ValueError(f"unknown Drewom engine {engine!r}")
        self._device = torch.device("cuda" if device is None else device)
        self._key = jr.key(seed, device=self._device)
        self._engine = engine

    def _impl_for(self, circuit: QCircuit) -> str:
        if self._engine == "dense":
            return "xla"
        if self._engine == "stabilizer":
            return "stabilizer"
        if circuit.n_qubits <= DENSE_QUBIT_CAP:
            return "xla"
        from qba_tpu_torch.qsim.stabilizer import is_clifford_ops

        if is_clifford_ops(circuit._circ.ops):
            return "stabilizer"
        raise ValueError(
            f"{circuit.n_qubits}-qubit circuit outside the stabilizer "
            "engine's gate set (S/T/rotations/multi-control change the "
            f"XZ normal form), and the dense engine caps at "
            f"{DENSE_QUBIT_CAP} qubits"
        )

    def execute(self, circuit: QCircuit, shots: int = 1) -> list[list[int]]:
        if not isinstance(circuit, QCircuit):
            raise TypeError("Drewom.execute expects a QCircuit")
        run = circuit._circ.compile_shots(self._impl_for(circuit))
        self._key, k = jr.split(self._key)
        bits = run(k, shots).cpu().numpy()
        order = list(circuit._measure_order())
        return [[int(b) for b in row[order]] for row in bits]
