"""Expressions and device kernels (port of ``spark_rapids_tpu/ops``)."""
