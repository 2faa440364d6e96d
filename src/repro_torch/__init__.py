"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``src/repro`` module for module and never imports JAX or
``repro``:

  repro_torch.core      the DLS chunk calculus, registry, metrics, planner
                        and the host kernel-tile planner (``torch_sched``)
  repro_torch.balance   ``plan_tiles`` / ``MoEBalancer`` for expert tiles
  repro_torch.kernels   dense and schedule-aware flash attention and the
                        grouped expert-tile matmul, each a CUDA kernel for
                        sm_90a beside its plain PyTorch version
  repro_torch.configs   the architecture configs (data)
  repro_torch.sharding  logical axis names -> specs and DTensor placements
                        on a ``DeviceMesh`` (``shard_as`` is the identity
                        on one GPU)
  repro_torch.random    ``jax.random``'s threefry bits, sampling
  repro_torch.models    the dense decoder: ``forward``, ``decode_step``
  repro_torch.serve     DLS admission and the ``DecodeEngine``
  repro_torch.launch    ``python -m repro_torch.launch.serve`` / ``.train``,
                        the production meshes (``launch.mesh``)
  repro_torch.device    ``resolve_device``: the card unless the CPU is asked
  repro_torch.convert   JAX parameter trees and decode states -> torch
"""

__version__ = "0.1.0"
