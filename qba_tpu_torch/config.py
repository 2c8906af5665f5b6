"""Typed, validated experiment configuration — mirror of
:class:`qba_tpu.config.QBAConfig`.

Field for field the same dataclass, with the same defaults, validation
messages and derived properties, so a config built for one package means
the same experiment in the other (``convert.config_from_jax_fields``
carries one across).  Every value the JAX package validates is accepted
here too; the one value the port does not run yet
(``qsim_path="stabilizer"``) raises ``NotImplementedError`` at run time
(:func:`qba_tpu_torch.rounds.engine.check_supported`), never a silent
demotion.  See the JAX class for the meaning of each field.
"""

from __future__ import annotations

import dataclasses
import math

# Joint-statevector feasibility bound (the dense qsim paths' ceiling).
DENSE_QUBIT_CAP = 20


@dataclasses.dataclass(frozen=True)
class QBAConfig:
    """Static parameters of one QBA experiment (see
    :class:`qba_tpu.config.QBAConfig` for each field)."""

    n_parties: int
    size_l: int
    n_dishonest: int = 0
    trials: int = 1
    seed: int = 0
    qsim_path: str = "factorized"
    max_accepts_per_round: int | None = None
    delivery: str = "sync"
    p_late: float = 0.0
    round_engine: str = "auto"
    attack_scope: str = "delivery"
    strategy: str = "reference"
    p_depolarize: float = 0.0
    p_measure_flip: float = 0.0
    racy_mode: str = "loss"
    tp_comms: str = "auto"
    tiled_block: int | None = None
    trial_pack: int | None = None
    max_evidence_rows: int | None = None
    collect_counters: bool = False
    mega_gen: str = "auto"

    def __post_init__(self) -> None:
        if self.n_parties < 2:
            raise ValueError("n_parties must be >= 2 (commander + >=1 lieutenant)")
        if self.size_l < 1:
            raise ValueError("size_l must be >= 1")
        if not 0 <= self.n_dishonest <= self.n_parties:
            raise ValueError(
                f"n_dishonest must be in [0, n_parties]; got {self.n_dishonest}"
            )
        if self.trials < 1:
            raise ValueError("trials must be >= 1")
        if self.qsim_path not in (
            "factorized", "dense", "dense_pallas", "stabilizer"
        ):
            raise ValueError(f"unknown qsim_path {self.qsim_path!r}")
        if self.qsim_path.startswith("dense") and (
            self.total_qubits > DENSE_QUBIT_CAP
        ):
            raise ValueError(
                f"dense qsim path infeasible at {self.total_qubits} qubits; "
                "use qsim_path='factorized'"
            )
        if self.max_accepts_per_round is not None and self.max_accepts_per_round < 1:
            raise ValueError("max_accepts_per_round must be >= 1")
        if self.delivery not in ("sync", "racy"):
            raise ValueError(f"unknown delivery model {self.delivery!r}")
        if not 0.0 <= self.p_late <= 1.0:
            raise ValueError("p_late must be in [0, 1]")
        if self.p_late > 0.0 and self.delivery != "racy":
            raise ValueError("p_late > 0 requires delivery='racy'")
        if self.round_engine not in (
            "auto", "xla", "pallas", "pallas_tiled", "pallas_fused",
            "pallas_mega",
        ):
            raise ValueError(f"unknown round_engine {self.round_engine!r}")
        if self.tp_comms not in ("auto", "ring", "all_gather"):
            raise ValueError(
                f"unknown tp_comms {self.tp_comms!r}; expected 'auto', "
                "'ring', or 'all_gather'"
            )
        if self.tiled_block is not None:
            n_pool = self.n_lieutenants * self.slots
            if self.tiled_block < 1 or n_pool % self.tiled_block:
                raise ValueError(
                    f"tiled_block={self.tiled_block} must divide "
                    f"n_lieutenants * slots = {n_pool}"
                )
        if self.trial_pack is not None and self.trial_pack < 1:
            raise ValueError(
                f"trial_pack={self.trial_pack} must be >= 1"
            )
        if self.max_evidence_rows is not None and (
            self.max_evidence_rows < self.n_rounds + 1
        ):
            raise ValueError(
                f"max_evidence_rows={self.max_evidence_rows} < n_rounds + 1 "
                f"= {self.n_rounds + 1}: every engine relies on |L| <= "
                "round+1 <= max_l (the append_own fullness guard must be "
                "unreachable, see consistent_after_append); a smaller "
                "bound would drop evidence rows mid-protocol"
            )
        if self.attack_scope not in ("delivery", "broadcast"):
            raise ValueError(f"unknown attack_scope {self.attack_scope!r}")
        from qba_tpu_torch.adversary.model import STRATEGIES

        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; "
                f"expected one of {sorted(STRATEGIES)}"
            )
        if self.attack_scope == "broadcast" and self.strategy != "reference":
            raise ValueError(
                "attack_scope='broadcast' models the reference's "
                "shared-object mutation accident and is only defined for "
                f"strategy='reference'; got strategy={self.strategy!r}"
            )
        if not 0.0 <= self.p_depolarize <= 1.0:
            raise ValueError(
                f"p_depolarize must be in [0, 1]; got {self.p_depolarize}"
            )
        if not 0.0 <= self.p_measure_flip <= 1.0:
            raise ValueError(
                f"p_measure_flip must be in [0, 1]; got {self.p_measure_flip}"
            )
        if self.mega_gen not in ("auto", "gf2", "host"):
            raise ValueError(
                f"unknown mega_gen {self.mega_gen!r}; expected 'auto', "
                "'gf2', or 'host'"
            )
        if self.mega_gen == "gf2" and self.qsim_path != "stabilizer":
            raise ValueError(
                "mega_gen='gf2' fuses the GF(2) stabilizer sampler into "
                "the trial megakernel and is only defined for "
                f"qsim_path='stabilizer'; got qsim_path={self.qsim_path!r}"
            )
        if self.racy_mode not in ("loss", "defer"):
            raise ValueError(f"unknown racy_mode {self.racy_mode!r}")
        if self.racy_mode == "defer" and self.delivery != "racy":
            raise ValueError("racy_mode='defer' requires delivery='racy'")

    @property
    def n_qubits(self) -> int:
        """Qubits per party group: ceil(log2(n_parties + 1))."""
        return max(1, math.ceil(math.log2(self.n_parties + 1)))

    @property
    def w(self) -> int:
        """Number of possible order values, 2**n_qubits."""
        return 2 ** self.n_qubits

    @property
    def total_qubits(self) -> int:
        """Joint circuit width: (n_parties + 1) * n_qubits."""
        return (self.n_parties + 1) * self.n_qubits

    @property
    def n_lieutenants(self) -> int:
        return self.n_parties - 1

    @property
    def n_rounds(self) -> int:
        """Voting rounds 1..n_dishonest+1."""
        return self.n_dishonest + 1

    @property
    def max_l(self) -> int:
        """Static bound on |L| (n_dishonest + 2 unless overridden)."""
        if self.max_evidence_rows is not None:
            return self.max_evidence_rows
        return self.n_dishonest + 2

    @property
    def slots(self) -> int:
        """Mailbox slots per (sender, round)."""
        if self.max_accepts_per_round is not None:
            return min(self.max_accepts_per_round, self.w)
        return self.w

    @property
    def no_decision(self) -> int:
        """Sentinel decision for an empty accepted-set Vi."""
        return self.w
