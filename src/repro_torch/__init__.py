"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``src/repro`` module for module and never imports JAX or
``repro``.  This slice holds the schedule-aware kernel path:

  repro_torch.core     the DLS chunk calculus, registry, metrics, planner
                       and the host kernel-tile planner (``torch_sched``)
  repro_torch.balance  ``plan_tiles`` / ``MoEBalancer`` for expert tiles
  repro_torch.kernels  flash attention over DLS-ordered KV descriptors and
                       the grouped expert-tile matmul, each a CUDA kernel
                       for sm_90a beside its plain PyTorch version
  repro_torch.device   ``resolve_device``: the card unless the CPU is asked
  repro_torch.convert  JAX parameter trees (as numpy) -> torch tensors
"""

__version__ = "0.1.0"
