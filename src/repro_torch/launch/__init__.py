"""Launch tooling for the port on one NVIDIA H100 (counterpart of
``repro.launch``'s measurement half).

* :mod:`repro_torch.launch.roofline` — the card's constants (``HW``), the
  time bound of a kernel's work (``bound_ms``, ``split_bound_ms``,
  ``kernel_work``), the ``Roofline`` record of a piece of work against
  that bound, and an LM's serving and training flops (``lm_model_flops``).
* :mod:`repro_torch.launch.trace_stats` — what the program did: an op
  record from a ``TorchDispatchMode`` (aten ops with shapes and dtypes,
  kernel launches, host syncs, the sharded routes' transfers) and the statistics of
  a ``torch.profiler`` run (kernels by name, device busy share, idle
  gaps).

The reference's ``dryrun``, ``perf`` and ``train`` lower and compile
training cells on a TPU mesh; they wait for the training slice.
"""
