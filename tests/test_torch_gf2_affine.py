"""The GF(2) sweep as an affine map equals the serial sweep, bit for bit.

A shot's outcomes are an affine map of its phases and coins, fixed by
its tableau (``qba_tpu_torch.gf2.affine``).  Here the map's bits
(``gf2_affine_map`` and ``gf2_affine_bits_reference``) are held against
JAX's ``gf2_measure_sweep`` (jitted) and the port's serial sweep on the
same seeded numpy phases and coins, for both protocol circuit families
at 3, 5 and 11 parties (48 qubits) and for random Clifford programs
whose sweeps take both branches and pivots past the first stabilizer
row.  The sweep kernel's table layout (``ops.gf2_sweep.sweep_tables``,
evaluated by ``affine_sweep_reference`` as the kernel reads it) is held
against the serial sweep on the protocol's list generation, with and
without noise, and the kernel wrapper on CPU tensors runs the plain
version and launches nothing.  Exact equality throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu.gf2 import symplectic as jsym
from qba_tpu_torch import QBAConfig
from qba_tpu_torch import gf2 as tgf2
from qba_tpu_torch import random as jr
from qba_tpu_torch.gf2.affine import gf2_affine_bits_reference, gf2_affine_map
from qba_tpu_torch.ops import gf2_sweep as gs
from qba_tpu_torch.qsim import protocol_circuits as tpc
from qba_tpu_torch.testing import random_sweep_inputs


def u32(words):
    """The port's int32 words as the JAX package's uint32."""
    return words.numpy().view(np.uint32)


def jax_sweep(n, x, z, r, coins):
    with jax.threefry_partitionable(True):
        return np.asarray(jax.jit(jsym.gf2_measure_sweep, static_argnums=0)(
            n, jnp.asarray(u32(x)), jnp.asarray(u32(z)),
            jnp.asarray(r.numpy().astype(np.int32)),
            jnp.asarray(coins.numpy().astype(np.int32))))


def check_map(n, x0w, z0w, shots, seed):
    """The map's bits against JAX's and the port's serial sweeps on
    ``shots`` seeded shots of one tableau; returns the serial work."""
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.integers(0, 2, (shots, 2 * n)).astype(np.uint8))
    coins = torch.from_numpy(rng.integers(0, 2, (shots, n)).astype(np.uint8))
    a, c = gf2_affine_map(n, x0w, z0w)
    assert a.dtype == torch.int32 and a.shape == (
        n, tgf2.n_words(2 * n) + tgf2.n_words(n))
    assert c.shape == (n,) and set(c.tolist()) <= {0, 1}
    got = gf2_affine_bits_reference(n, a, c, r, coins)
    x = x0w[None].expand(shots, -1, -1)
    z = z0w[None].expand(shots, -1, -1)
    work = {}
    serial = tgf2.gf2_measure_sweep(n, x, z, r, coins, work=work)
    assert torch.equal(got, serial)
    assert np.array_equal(got.numpy(), jax_sweep(n, x, z, r, coins))
    return work


@pytest.mark.parametrize("n_parties", [3, 5, 11])
@pytest.mark.parametrize("family", ["q", "nq"])
def test_affine_map_on_protocol_families(n_parties, family):
    cfg = QBAConfig(n_parties=n_parties, size_l=4)
    x_q, z_q, x_nq, z_nq = tpc.stabilizer_gen_tables(cfg)
    x, z = (x_q, z_q) if family == "q" else (x_nq, z_nq)
    check_map(cfg.total_qubits, x, z, 12, n_parties)


@pytest.mark.parametrize("n,seed", [(12, 3), (33, 7), (45, 4)])
def test_affine_map_on_random_clifford_programs(n, seed):
    xw, zw, *_ = random_sweep_inputs(n, 1, seed)
    for f in range(2):
        work = check_map(n, xw[f], zw[f], 16, seed + f)
        # Both branches ran, and pivots fell past the first stabilizer row.
        assert work["random_steps"] and work["det_steps"]
        assert work["late_pivots"]


def test_affine_map_rejects_a_wrong_tableau():
    xw, zw, *_ = random_sweep_inputs(6, 1, 0)
    with pytest.raises(ValueError, match="2n rows"):
        gf2_affine_map(7, xw[0], zw[0])


@pytest.mark.parametrize("n", [12, 40])
def test_kernel_tables_on_random_tableaux(n):
    args = random_sweep_inputs(n, 32, seed=n)
    xw, zw, r, coins, family, mflip = args
    tables = gs.sweep_tables(n, xw, zw)
    _wr, _wc, wt, n_pad = gs.table_dims(n)
    assert tables.shape == (2, wt, n_pad) and not tables[:, :, n:].any()
    want = gs.gf2_sweep_reference(n, *args)
    assert torch.equal(
        gs.affine_sweep_reference(n, tables, r, coins, family, mflip), want)
    # One family, no readout flips.
    assert torch.equal(
        gs.affine_sweep_reference(n, tables[:1], r, coins),
        gs.gf2_sweep_reference(n, xw[:1], zw[:1], r, coins))


@pytest.mark.parametrize("n_parties,noisy", [(5, True), (11, False),
                                             (11, True)])
def test_stabilizer_bits_through_the_map(n_parties, noisy):
    cfg = QBAConfig(n_parties=n_parties, size_l=16,
                    p_depolarize=0.05 * noisy, p_measure_flip=0.02 * noisy)
    ops = tpc.stabilizer_gen_operands(cfg, jr.split(jr.key(n_parties), 3))
    tables = tpc.stabilizer_gen_tables(cfg)
    want = tpc.stabilizer_bits(cfg, tables, ops,
                               sweep=gs.gf2_sweep_reference)
    if noisy:
        assert ops[4].any()  # readout flips reach the bits
    sweep_tables = tpc.stabilizer_sweep_tables(cfg)
    assert tpc.stabilizer_sweep_tables(cfg) is sweep_tables  # built once

    def through_map(n, xw, zw, r, coins, family, mflip):
        assert torch.equal(gs.sweep_tables(n, xw, zw), sweep_tables)
        return gs.affine_sweep_reference(n, sweep_tables, r, coins, family,
                                         mflip)

    assert torch.equal(tpc.stabilizer_bits(cfg, tables, ops,
                                           sweep=through_map), want)
    before = gs.gf2_sweep.launches
    assert torch.equal(tpc.stabilizer_bits(cfg, tables, ops), want)
    assert gs.gf2_sweep.launches == before


@pytest.mark.parametrize("n_parties,in_shared", [(11, True), (33, True),
                                                 (65, False)])
def test_sweep_table_sizes(n_parties, in_shared):
    cfg = QBAConfig(n_parties=n_parties, size_l=4)
    n = cfg.total_qubits
    tables = tpc.stabilizer_sweep_tables(cfg)
    wr, wc, wt, n_pad = gs.table_dims(n)
    assert (wr, wc) == (tgf2.n_words(2 * n), tgf2.n_words(n))
    assert tables.shape == (2, wt, n_pad) and n_pad % 32 == 0
    assert gs.tables_in_shared(tables) == in_shared


def test_sweep_wrapper_on_cpu_launches_nothing():
    n = 20
    args = random_sweep_inputs(n, 16, seed=5)
    before = gs.gf2_sweep.launches
    got = gs.gf2_sweep(n, *args)
    assert gs.gf2_sweep.launches == before
    assert torch.equal(got, gs.gf2_sweep_reference(n, *args))
