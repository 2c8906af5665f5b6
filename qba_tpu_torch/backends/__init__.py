"""Execution backends of the port — counterpart of :mod:`qba_tpu.backends`.

* ``torch`` — the batched runner (:mod:`~qba_tpu_torch.backends.
  torch_backend`): trials on a trial axis, the round engine's kernels on
  CUDA, their plain versions on the CPU.
* ``local`` — a message-level pure-Python path preserving the per-party
  send/receive structure (sets of tuples, per-party mailboxes), for
  differential testing (:mod:`~qba_tpu_torch.backends.local_backend`).
* ``native`` — the same message-level semantics in the C++ host runtime
  (:mod:`qba_tpu_torch.native`), every packet through the PvL wire codec.
* ``mp`` — one OS process per party over a Unix-socket mesh, every packet
  through the C++ codec across a process boundary
  (:mod:`~qba_tpu_torch.backends.mp_backend`).

The three message-level backends consume the batched runner's keyed
randomness, presampled on the keys' device in one batch
(:func:`~qba_tpu_torch.backends.local_backend.presample_batch`), so all
four agree trial for trial.
"""

# Lazy exports: the mp backend's party processes import
# qba_tpu_torch.backends.mp_party (torch-free) through this package, and an
# eager torch_backend import here would load torch in every one of them.
_EXPORTS = {
    "MonteCarloResult": ("qba_tpu_torch.backends.torch_backend",
                         "MonteCarloResult"),
    "run_trials": ("qba_tpu_torch.backends.torch_backend", "run_trials"),
    "trial_keys": ("qba_tpu_torch.backends.torch_backend", "trial_keys"),
    "run_trial_local": ("qba_tpu_torch.backends.local_backend",
                        "run_trial_local"),
    "run_trial_native": ("qba_tpu_torch.backends.native_backend",
                         "run_trial_native"),
    "run_trial_mp": ("qba_tpu_torch.backends.mp_backend", "run_trial_mp"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
