"""The per-round kernels' host-side layout helpers, on the CPU.

The CUDA kernels (``csrc/fused_round.cu``, ``tiled_round.cu`` and
``round_step.cu`` over ``csrc/round_common.cuh``) lay out their shared
memory themselves; the Python mirror checked here against counts made by
hand decides which configurations the wrappers admit.  The lane-group
mirror, the phase clock's buffer and breakdown, and the plain versions'
refusal of a clock are checked too.  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``).
"""

import pytest

torch = pytest.importorskip("torch")

from qba_tpu_torch import QBAConfig
from qba_tpu_torch.ops import round_kernel as rs
from qba_tpu_torch.ops import round_kernel_tiled as rk
from qba_tpu_torch.testing import random_mailbox_inputs, random_round_inputs

torch.set_num_threads(1)


def a16(x):
    return -(-x // 16) * 16


def smem_by_hand(n_rv, n_glob, slots, max_l, size_l, verdict=True,
                 slot_lists=True):
    """Smem's offsets written out for a block of n_rv receivers of n_glob:
    the accepted sets (8 B a receiver), slots (4 B each, where the kernel
    takes slot lists: all but the tiled verdict), counts and
    offsets, then 16-aligned, the eight flags; with the verdict's parts:
    each of 8 warps' lossy receivers (8 B), each cell's verdict (8 B) and order (4 B), the sent and honesty bits
    (4 B a word of 32 cells each), the sent cells' list (4 B a cell), the
    lists and their out-of-range words (4 B a word of four positions, n_rv
    + 1 words a position row), then 16-aligned, two packet buffers for
    each of 8 warps (lens, P and the rows, each part 16-aligned) where
    they fit 232,448 B, else one."""
    n_pool = n_glob * slots
    sw = -(-size_l // 4)
    at = a16(8 * n_rv + (4 * n_rv * slots if slot_lists else 0) + 4 * n_rv
             + 4 * (n_rv + 1)) + 32
    if not verdict:
        return at
    at += 8 * 8 + 8 * n_pool + 4 * n_pool + 2 * 4 * -(-n_pool // 32) + 4 * n_pool
    at = a16(at + 2 * 4 * sw * (n_rv + 1))
    buf = a16(4 * max_l) + a16(4 * sw) + a16(4 * sw * max_l)
    return at + 8 * (2 if at + 16 * buf <= 232448 else 1) * buf


# (parties, size_l, dishonest, tp, slots one) -> (lieutenants, slots,
# max_l, shared memory of a verdict kernel's block, of the tiled rebuild's).
SMEM = {
    (5, 16, 2, 1, False): (4, 8, 4, 2528, 240),
    (5, 16, 2, 2, False): (4, 8, 4, 2368, 144),
    (9, 10, 3, 1, False): (8, 16, 5, 4848, 688),
    (11, 64, 3, 1, False): (10, 16, 5, 11584, 848),
    (11, 64, 3, 2, False): (10, 16, 5, 10544, 448),
    (11, 64, 3, 1, True): (10, 1, 5, 8544, 240),
    (33, 64, 10, 1, False): (32, 64, 12, 60400, 8752),
    (33, 64, 10, 4, False): (32, 64, 12, 50800, 2224),
    (41, 64, 13, 1, False): (40, 64, 15, 75248, 10928),
    (41, 64, 13, 4, False): (40, 64, 15, 63248, 2768),
    # Two buffers a warp would not fit: one.
    (33, 1024, 10, 1, False): (32, 64, 12, 216560, 8752),
}


@pytest.mark.parametrize("shape", list(SMEM))
def test_round_smem_bytes_by_hand(shape):
    n, s, d, tp, one = shape
    cfg = QBAConfig(n_parties=n, size_l=s, n_dishonest=d,
                    **(dict(max_accepts_per_round=1) if one else {}))
    n_rv, slots, max_l, smem, rebuild = SMEM[shape]
    assert (cfg.n_lieutenants, cfg.slots, cfg.max_l) == (n_rv, slots, max_l)
    n_local = n_rv // tp
    assert rk.round_smem_bytes(cfg, n_local) == smem
    assert rk.round_smem_bytes(cfg, n_local, verdict=False) == rebuild
    assert smem_by_hand(n_local, n_rv, slots, max_l, s) == smem
    assert smem_by_hand(n_local, n_rv, slots, max_l, s, False) == rebuild
    assert smem <= rk.SMEM_LIMIT
    assert rk.round_smem_bytes(cfg) == rk.round_smem_bytes(cfg, n_rv)


# The tiled verdict's block takes no slot lists (4 B a receiver and
# slot fewer): (parties, size_l, dishonest, tp) -> its shared memory.
VERDICT_SMEM = {
    (5, 16, 2, 1): 2400,
    (11, 64, 3, 1): 10944,
    (11, 64, 3, 2): 10224,
    (33, 64, 10, 1): 52208,
    (33, 64, 10, 4): 48752,
}


@pytest.mark.parametrize("shape", list(VERDICT_SMEM))
def test_tiled_verdict_smem_by_hand(shape):
    n, s, d, tp = shape
    cfg = QBAConfig(n_parties=n, size_l=s, n_dishonest=d)
    n_rv = cfg.n_lieutenants
    want = VERDICT_SMEM[shape]
    assert rk.round_smem_bytes(cfg, n_rv // tp, slots=False) == want
    assert smem_by_hand(n_rv // tp, n_rv, cfg.slots, cfg.max_l, s,
                        slot_lists=False) == want
    # 33 parties: four blocks an SM fit the SM's 228 KB (1 KB reserved a
    # block), where the layout with slot lists fits three.
    if (n, tp) == (33, 1):
        assert 4 * (want + 1024) <= 228 * 1024
        assert 4 * (rk.round_smem_bytes(cfg) + 1024) > 228 * 1024


def test_round_smem_past_the_card_raises():
    # 2048 positions at 33 parties need more than a block's shared memory
    # even with one buffer a warp: the wrapper says so before a launch.
    cfg = QBAConfig(n_parties=33, size_l=2048, n_dishonest=10)
    assert rk.round_smem_bytes(cfg) > rk.SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="shared memory"):
        rk.check_round_smem(cfg, cfg.n_lieutenants, "fused round")
    rk.check_round_smem(QBAConfig(n_parties=33, size_l=1024, n_dishonest=10),
                        32, "fused round")


@pytest.mark.parametrize("n_rv", range(1, 65))
def test_lane_groups_cover_the_receivers(n_rv):
    # A pass runs 32 / G receivers, G lanes each; the passes cover the
    # block's receivers in at most two (the kernels' draw registers hold
    # two), and a group of G > 1 only where one pass holds them all.
    g = rk.lane_group(n_rv)
    per_pass = 32 // g
    passes = -(-n_rv // per_pass)
    assert g in (1, 2, 4) and passes == (2 if n_rv > 32 else 1)
    assert g == 1 or n_rv <= per_pass


@pytest.mark.parametrize("n_local", [1, 4, 31, 32, 33, 64])
def test_pack_acc_round_trip(n_local):
    # One receiver mask a packet: bit r is receiver r's entry, 0 past
    # n_local; bit 63 is the sign bit of the int64 word.
    gen = torch.Generator().manual_seed(n_local)
    acc = (torch.rand((3, 7, n_local), generator=gen) < 0.5).to(torch.int32)
    words = rk.pack_acc(acc)
    assert words.dtype == torch.int64 and words.shape == (3, 7)
    assert torch.equal(rk.unpack_acc(words, n_local), acc)
    assert torch.equal(rk.pack_acc(acc != 0), words)
    if n_local < 64:
        assert not (words >> n_local).any()
    one = torch.zeros(n_local, dtype=torch.int32)
    one[-1] = 1
    assert int(rk.pack_acc(one)) == (-(1 << 63) if n_local == 64
                                     else 1 << (n_local - 1))
    assert int(rk.pack_acc(torch.ones(64, dtype=torch.int32))) == -1
    with pytest.raises(ValueError, match="64-bit"):
        rk.pack_acc(torch.ones(65, dtype=torch.int32))


def test_round_phase_clock_buffer_and_breakdown():
    assert rk.round_phase_clock(3).shape == (3, len(rk.ROUND_PHASES))
    clock = rk.round_phase_clock(2, 4)
    assert clock.shape == (4, 2, len(rk.ROUND_PHASES))
    assert clock.dtype == torch.int64 and not clock.any()
    # Two blocks: block 0 spends 30 cycles in set-up and 10 in the
    # receivers, block 1 90 in the receivers.
    clock = rk.round_phase_clock(2)
    clock[0, rk.ROUND_PHASES.index("setup")] = 30
    clock[0, rk.ROUND_PHASES.index("receivers")] = 10
    clock[1, rk.ROUND_PHASES.index("receivers")] = 90
    out = rk.round_phase_breakdown(clock)
    assert out["setup"] == dict(cycles=15.0, share=15.0 / 65.0)
    assert out["receivers"] == dict(cycles=50.0, share=50.0 / 65.0)
    assert out["block"] == dict(mean=65.0, max=90.0)


def test_plain_versions_refuse_the_clock():
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    pool, li, vi, hc, *draws = random_round_inputs(cfg, 1, 4, seed=1)
    clock = rk.round_phase_clock(4)
    with pytest.raises(ValueError, match="phase clock"):
        rk.fused_round(cfg, 1, pool, li, vi, hc, *draws, clock=clock)
    args = random_mailbox_inputs(cfg, 1, 4, seed=1)
    with pytest.raises(ValueError, match="phase clock"):
        rs.round_step(cfg, 1, *args, clock=clock)
    # Without a clock the plain versions run.
    assert rk.fused_round(cfg, 1, pool, li, vi, hc, *draws)[1].shape == vi.shape
