"""Device kernels: row operations, joins, group-by (port of
``spark_rapids_tpu/ops/kernels``), and the CUDA kernels in ``cuda/``."""
