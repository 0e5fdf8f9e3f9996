"""PyTorch/CUDA port of the columnar SQL engine in ``spark_rapids_tpu``.

The JAX package stays the reference; this package mirrors its layout
module for module (``types``, ``config``, ``compile.ladder``, ``data``,
``ops``, ``ops.kernels``, ``plan``, ``exec``, ``session``,
``workloads``) and runs on an NVIDIA GPU through PyTorch, with the
reference's Pallas kernels replaced by hand-written CUDA C++ kernels
(``ops/kernels/cuda/``).

Numerics follow the reference's x64 stance: integer lanes are int64,
float lanes float64, dates int32 days since the epoch. Host data is
numpy; nothing here imports JAX, pyarrow or the JAX package.

Entry point: :class:`spark_rapids_tpu_torch.session.TorchSession`.
"""

__version__ = "0.1.0"
