"""Bit-packed GF(2) linear algebra and the aggregate-symplectic
stabilizer sampler — counterpart of :mod:`qba_tpu.gf2`."""

from qba_tpu_torch.gf2.bitops import (
    WORD,
    get_bit,
    mask_words,
    n_words,
    pack_bits,
    parity_words,
    prefix_xor_exclusive,
    unit_words,
    unpack_bits,
)
from qba_tpu_torch.gf2.linalg import (
    GF2_TILE_K,
    gf2_matmul,
    gf2_matvec,
    rank1_update_packed,
    triangular_parity,
)
from qba_tpu_torch.gf2.symplectic import (
    SymplecticProgram,
    build_gf2_sample_core,
    build_gf2_tableau_run_batch,
    build_gf2_tableau_run_shots,
    compile_symplectic,
    gf2_measure_sweep,
)

__all__ = [
    "WORD",
    "GF2_TILE_K",
    "SymplecticProgram",
    "build_gf2_sample_core",
    "build_gf2_tableau_run_batch",
    "build_gf2_tableau_run_shots",
    "compile_symplectic",
    "get_bit",
    "gf2_matmul",
    "gf2_matvec",
    "gf2_measure_sweep",
    "mask_words",
    "n_words",
    "pack_bits",
    "parity_words",
    "prefix_xor_exclusive",
    "rank1_update_packed",
    "triangular_parity",
    "unit_words",
    "unpack_bits",
]
