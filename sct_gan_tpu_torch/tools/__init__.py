"""Kernel-timing entry points of the port: the JAX repo's ``tools/time_*``
kernel decompositions, one hand-written CUDA kernel each (``csrc/``).

  time_flash_parts            K7: flash forward, full vs noexp vs mmonly
  time_flash_variants         K8: single-pass softmax variants
  time_decode_kernel_variants K9: decode-attention blocking, v1 v2 v3
  time_dropout_kernel         K10: dropout draws against a copy

Each module holds its kernel's wrapper (a CPU tensor runs the plain
PyTorch version, a CUDA tensor the kernel), the plain version,
``time_modes()`` and ``main()``. Run one on the card with

    python3 -m sct_gan_tpu_torch.tools.time_flash_parts

The entry points measure the card and raise without one.
"""
