"""Launch tooling for the port on one NVIDIA H100 (counterpart of
``repro.launch``).

* :mod:`repro_torch.launch.roofline` — the card's constants (``HW``), the
  time bound of a kernel's work (``bound_ms``, ``split_bound_ms``,
  ``kernel_work``), the ``Roofline`` record of a piece of work against
  that bound, and an LM's serving and training flops (``lm_model_flops``).
* :mod:`repro_torch.launch.trace_stats` — what the program did: an op
  record from a ``TorchDispatchMode`` (aten ops with shapes and dtypes,
  kernel launches, host syncs, the sharded routes' transfers) and the statistics of
  a ``torch.profiler`` run (kernels by name, device busy share, idle
  gaps).

* :mod:`repro_torch.launch.mesh` — the production meshes as records (axis
  names and sizes) for the rules' accounting, the local cards as a mesh,
  and ``HW`` with the card's memory.
* :mod:`repro_torch.launch.dryrun` — every (arch x shape) cell on both
  production meshes: its step run once on the ``meta`` device (shapes and
  dtypes at full size, no memory), its flops bound and its per-card state
  bytes under the sharding rules (the reference lowers and compiles each
  cell instead).
* :mod:`repro_torch.launch.perf` — the perf harness's cells on the card
  (``jag_serve``, ``qwen3_train``, ``din_train``) and ``maverick_train``'s
  dry-run rows.
* :mod:`repro_torch.launch.train` — the fault-tolerant training launcher
  (resume from checkpoints, straggler log, metrics JSONL).
"""
