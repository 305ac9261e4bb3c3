"""PyTorch / CUDA port of ``medsam2_tpu``.

Mirrors the JAX package's module layout (``core/``, ``state/``, ``api/``,
``ops/``, ``checkpoint/``); the JAX package is the reference every module here
is tested against. The two attention kernels of the 3D propagation path are
hand-written CUDA for Hopper (``csrc/``), built at first use by
:mod:`medsam2_tpu_torch.ops._build`.
"""
