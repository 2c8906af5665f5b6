"""Static analyses of the port — counterpart of :mod:`qba_tpu.analysis`
(of its :mod:`~qba_tpu_torch.analysis.memory` trial ceiling only; the
jaxpr and plan lints wait for ROADMAP A13)."""
