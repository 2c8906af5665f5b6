"""The port's invariant checker (``python -m qba_tpu_torch lint``) — the
counterpart of :mod:`qba_tpu.analysis` — and the fleet's memory price
(:mod:`~qba_tpu_torch.analysis.memory`).

The JAX package's passes read jaxprs; the port's run on its own
objects: the kernel wrappers' launch seams, the calls PyTorch
dispatches, the CUDA allocator's counts and
``torch.cuda.set_sync_debug_mode``.  One module a pass, as in the JAX
package: :mod:`.dots` (KI-3), :mod:`.memory` (KI-2), :mod:`.launches`
and :mod:`.effects` (KI-5), :mod:`.transfers` (KI-6), :mod:`.manifests`
(KI-8), :mod:`.protocol` over :mod:`.fsm` (KI-10), :mod:`.atlas`
(KI-11), :mod:`.obs` (KI-12); :mod:`.trace` records the batches and
:mod:`.driver` runs them (it says what has no counterpart).
"""

from qba_tpu_torch.analysis.findings import Finding, Report  # noqa: F401


def run_lint(configs=None, engines=None, effects=False, protocol=False,
             device="cuda") -> Report:
    """Lazy forwarder to :func:`qba_tpu_torch.analysis.driver.run_lint`,
    so importing the package stays light."""
    from qba_tpu_torch.analysis.driver import run_lint as _run

    return _run(configs=configs, engines=engines, effects=effects,
                protocol=protocol, device=device)
