"""Hand-written Hopper kernels of the port, each beside its plain version.

  flash_attention — blocked online-softmax attention forward (CUDA C++, sm_90a)
  ops             — dispatch: CUDA tensors to the kernel, CPU tensors to the
                    plain version
  build           — nvcc at first use, ctypes binding

Importing this package builds nothing and needs neither a card nor nvcc.
"""
