"""PyTorch / CUDA port of ``medsam2_tpu``.

Mirrors the JAX package's module layout (``core/``, ``state/``, ``api/``,
``ops/``, ``train/``, ``data/``, ``metrics/``, ``checkpoint/``, ``cli/``); the
JAX package is the reference every module here is tested against. The
attention kernels of the 3D propagation and 3D training paths (flash forward
and its backward pair, storage-order kv-cached cross-attention) are
hand-written CUDA for Hopper (``csrc/``), built at first use by
:mod:`medsam2_tpu_torch.ops._build`.
"""
