"""The trial megakernel's host-side layout helpers, on the CPU.

The CUDA kernel (``csrc/trial_megakernel.cu`` over ``csrc/mega_phases.cuh``)
keeps its pools entry-major and lays out its shared memory itself; the
wrappers allocate the pools and the launches' shared memory from the
Python mirrors checked here against counts made by hand.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import pytest

torch = pytest.importorskip("torch")

from qba_tpu_torch import QBAConfig
from qba_tpu_torch.ops import _build
from qba_tpu_torch.ops import round_kernel_tiled as rk
from qba_tpu_torch.ops import trial_megakernel as tm

torch.set_num_threads(1)

# (parties, size_l, dishonest) -> (lieutenants, slots, max_l, entry bytes).
# An entry: meta 16 B, lens 4 * max_l padded to 16, P and each of max_l
# rows 4 * ceil(size_l / 4) bytes, P and the rows each padded to 16
# (9p/L10: rows of 12 bytes, 60 padded to 64).
ENTRY = {
    (5, 16, 2): (4, 8, 4, 16 + 16 + 16 + 64),
    (11, 64, 3): (10, 16, 5, 16 + 32 + 64 + 320),
    (33, 64, 10): (32, 64, 12, 16 + 48 + 64 + 768),
    (41, 64, 13): (40, 64, 15, 16 + 64 + 64 + 960),
    (9, 10, 3): (8, 16, 5, 16 + 32 + 16 + 64),
}


@pytest.mark.parametrize("shape", list(ENTRY))
def test_entry_bytes_by_hand(shape):
    n, s, d = shape
    cfg = QBAConfig(n_parties=n, size_l=s, n_dishonest=d)
    n_rv, slots, max_l, entry = ENTRY[shape]
    assert (cfg.n_lieutenants, cfg.slots, cfg.max_l) == (n_rv, slots, max_l)
    assert tm.mega_entry_bytes(cfg) == entry
    assert entry % 16 == 0  # whole 16-byte copies


def smem_by_hand(n_rv, n_glob, n_pool, slots, sw, entry, keyed):
    """MegaSmem's offsets written out for a block of n_rv receivers of
    n_glob: verdict and accepted masks, packet infos, honesty bits, slots,
    counts, offsets (then 16-aligned), misc, li and oor words [sw][n_glob
    + 1] (then 16-aligned), two entries for each of 16 warps; the keyed
    words (two rounds' keys, the collude target and 64 orders) and 16
    warps' draw rows past it."""
    at = 8 * n_pool + 8 * n_rv + 4 * n_pool + 4 * -(-n_pool // 32)
    at += 4 * n_rv * slots + 4 * n_rv + 4 * (n_rv + 1)
    at = -(-at // 16) * 16 + 32 + 2 * 4 * sw * (n_glob + 1)
    at = -(-at // 16) * 16 + 16 * 2 * entry
    return at + (4 * 80 + 16 * 192 if keyed else 0)


# (parties, size_l, dishonest, tp) -> shared memory of the keyed entry.
SMEM = {
    (5, 16, 2, 1): 7760,
    (11, 64, 3, 1): 21408,
    (11, 64, 3, 2): 21008,
    (33, 64, 10, 1): 69872,
    (33, 64, 10, 4): 63344,
    (41, 64, 13, 1): 85936,
}


@pytest.mark.parametrize("shape", list(SMEM))
def test_smem_bytes_by_hand(shape):
    n, s, d, tp = shape
    cfg = QBAConfig(n_parties=n, size_l=s, n_dishonest=d)
    n_rv = cfg.n_lieutenants // tp
    args = (n_rv, cfg.n_lieutenants, cfg.n_lieutenants * cfg.slots,
            cfg.slots, -(-s // 4), tm.mega_entry_bytes(cfg))
    assert tm.mega_smem_bytes(cfg, tp) == SMEM[shape]
    assert smem_by_hand(*args, keyed=True) == SMEM[shape]
    assert tm.mega_smem_bytes(cfg, tp, keyed=False) == smem_by_hand(
        *args, keyed=False)
    # Two blocks fit an SM's 228 KB (1 KB reserved a block) up to 41p.
    assert 2 * (SMEM[shape] + 1024) <= 228 * 1024


# (parties, size_l, dishonest) -> whether the H100's 227 KB a block holds
# sixteen warps' two entry buffers: up to about 400 positions at 33p.
STAGED = {(11, 64, 3): True, (11, 1000, 3): True, (33, 64, 10): True,
          (33, 400, 10): True, (33, 416, 10): False, (33, 1000, 10): False,
          (41, 64, 13): True}


@pytest.mark.parametrize("shape", list(STAGED))
def test_staged_layout(shape):
    n, s, d = shape
    cfg = QBAConfig(n_parties=n, size_l=s, n_dishonest=d)
    assert tm.mega_staged(cfg) == STAGED[shape]
    # In place the block keeps no entry buffers and fits at any of these.
    unstaged = tm.mega_smem_bytes(cfg, staged=False)
    assert tm.mega_smem_bytes(cfg) - unstaged == 16 * 2 * tm.mega_entry_bytes(
        cfg)
    assert unstaged <= 232448


@pytest.mark.parametrize("n_rv,g", [(1, 4), (4, 4), (8, 4), (9, 2), (10, 2),
                                    (16, 2), (17, 1), (32, 1), (40, 1),
                                    (64, 1)])
def test_lane_group(n_rv, g):
    # G lanes a receiver: one pass holds every receiver up to 32.  The
    # megakernel's verdict and the per-round kernels' share the helper
    # (round_common.cuh) and its mirror.
    assert rk.lane_group(n_rv) == g
    assert 32 // g >= min(n_rv, 32)


def test_outputs_are_entry_major_pools():
    cfg = QBAConfig(n_parties=11, size_l=64, n_dishonest=3)
    out = tm._outputs(cfg, 7, torch.device("cpu"))
    pools, (vi, dec, ovf) = out[:2], out[2:]
    for p in pools:
        assert p.dtype == torch.uint8
        assert tuple(p.shape) == (7, 10 * 16, tm.mega_entry_bytes(cfg))
    assert pools[0].data_ptr() != pools[1].data_ptr()
    assert tuple(vi.shape) == (7, 10, cfg.w) and vi.dtype == torch.int32
    assert tuple(dec.shape) == (7, 10)
    assert tuple(ovf.shape) == (7,)
    assert tuple(tm._outputs(cfg, 7, "cpu", 2)[-1].shape) == (7, 2)


def test_phase_clock_and_breakdown():
    clock = tm.phase_clock(3, 2)
    assert clock.dtype == torch.int64
    assert tuple(clock.shape) == (3, 2, len(tm.MEGA_PHASES))
    assert not clock.any()
    clock[..., tm.MEGA_PHASES.index("verdict")] = 30
    clock[..., tm.MEGA_PHASES.index("rebuild")] = 10
    clock[0, 0, tm.MEGA_PHASES.index("rebuild")] = 70
    out = tm.phase_breakdown(clock)
    assert out["verdict"]["cycles"] == 30
    assert out["rebuild"]["cycles"] == 20
    assert out["verdict"]["share"] == pytest.approx(0.6)
    assert out["block"] == dict(mean=50.0, max=100.0)
    assert sum(out[p]["share"] for p in tm.MEGA_PHASES) == pytest.approx(1)


def test_phase_clock_is_refused_on_the_cpu():
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2, trials=2)
    from qba_tpu_torch.testing import random_trial_inputs

    p_rows, li, v_sent, hc, *_ = random_trial_inputs(cfg, 2, seed=1)
    k_rounds = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="phase clock"):
        tm.trial_megakernel_keyed(cfg, p_rows, li, v_sent, hc, k_rounds,
                                  None, clock=tm.phase_clock(2))
    with pytest.raises(ValueError, match="phase clock"):
        tm.sharded_trial_megakernel_keyed(cfg, 2, p_rows, li, v_sent, hc,
                                          k_rounds, None,
                                          clock=tm.phase_clock(2, 2))


def test_mega_header_rebuilds_only_the_megakernel(tmp_path, monkeypatch):
    # The megakernel's phases live in their own header: an edit there
    # changes the megakernel's build key and no other kernel's.
    import shutil

    assert "mega_phases.cuh" in [p.name for p in
                                 _build.sources("trial_megakernel")]
    before = {name: _build._target(name)[1].name for name in _build.KERNELS}
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    with open(copy / "mega_phases.cuh", "a") as f:
        f.write("// edit\n")
    changed = {name for name in _build.KERNELS
               if _build._target(name)[1].name != before[name]}
    assert changed == {"trial_megakernel"}
