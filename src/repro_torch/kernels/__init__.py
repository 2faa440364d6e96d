"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

flash_attention/  flash attention: the dense causal / sliding-window kernel
                  and the one over DLS-ordered (lane, q, kv) descriptors
grouped_matmul/   DLS-planned expert-tile matmul
csrc/             the CUDA sources; _build.py compiles and binds them

Each kernel package ships <name>.py (plain version + launch wrapper),
ops.py (the public wrapper with the reference's keywords) and ref.py (the
plain oracle).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
