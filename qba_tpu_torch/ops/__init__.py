"""Kernels of the port and their plain PyTorch versions."""


def kernel_wrappers() -> dict:
    """Every kernel wrapper by name.  Each counts its launches on its
    ``launches`` attribute (:func:`~qba_tpu_torch.ops._launch.
    timed_launch`); the plain versions count nothing."""
    from qba_tpu_torch.ops import attack_draws as ad
    from qba_tpu_torch.ops import fused_circuit as fc
    from qba_tpu_torch.ops import gf2_sweep as gs
    from qba_tpu_torch.ops import ring_shuffle as rg
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.ops import setup_kernel as sk
    from qba_tpu_torch.ops import surface_loop as su
    from qba_tpu_torch.ops import sweep_loop as sl
    from qba_tpu_torch.ops import trial_megakernel as tm

    return {"fused_round": rk.fused_round, "tiled_verdict": rk.tiled_verdict,
            "tiled_rebuild": rk.tiled_rebuild,
            "trial_megakernel": tm.trial_megakernel,
            "round_step": rs.round_step, "fused_circuit": fc.fused_circuit,
            "gf2_sweep": gs.gf2_sweep,
            "trial_megakernel_gen": tm.trial_megakernel_gen,
            "sharded_trial_megakernel": tm.sharded_trial_megakernel,
            "ring_gather": rg.ring_gather,
            "attack_draws": ad.attack_draws,
            "trial_megakernel_keyed": tm.trial_megakernel_keyed,
            "trial_megakernel_gen_keyed": tm.trial_megakernel_gen_keyed,
            "sharded_trial_megakernel_keyed":
                tm.sharded_trial_megakernel_keyed,
            "sweep_stop": sl.sweep_stop,
            "surface_pick": su.surface_pick,
            "surface_fold": su.surface_fold,
            "setup_trial": sk.setup_kernel,
            "trial_keys": sk.keys_kernel}


def kernel_launches() -> dict[str, int]:
    """This process's launches of each kernel launched at least once."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()
            if fn.launches}
