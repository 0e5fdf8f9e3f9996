"""Benchmark workloads (port of ``spark_rapids_tpu/workloads``)."""
