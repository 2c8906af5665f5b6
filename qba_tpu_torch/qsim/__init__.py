"""Quantum resource generation — the factorized path of
:mod:`qba_tpu.qsim`."""

from qba_tpu_torch.qsim.sampler import generate_lists


def generate_lists_for(cfg, keys):
    """Dispatch list generation on ``cfg.qsim_path``.  Only the
    factorized sampler is ported; the stabilizer and dense paths are
    ROADMAP queue A items 7 and 8."""
    if cfg.qsim_path == "factorized":
        return generate_lists(cfg, keys)
    raise NotImplementedError(
        f"qsim_path={cfg.qsim_path!r} is not ported yet (ROADMAP A7/A8); "
        "use qsim_path='factorized'"
    )


__all__ = ["generate_lists", "generate_lists_for"]
