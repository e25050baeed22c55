"""Hand-written Hopper kernels of the port, each beside its plain version.

  flash_attention — blocked online-softmax attention forward (CUDA C++, sm_90a)
  phase_max       — CSR segment max of the simulator's rate resolution
  rwkv6           — RWKV6 / Mamba2 chunked linear recurrence
  ops             — dispatch: CUDA tensors to the kernel, CPU tensors to the
                    plain version
  build           — nvcc at first use, ctypes binding

Importing this package builds nothing and needs neither a card nor nvcc.
"""
