"""Capacity policy (port of ``spark_rapids_tpu/compile``; only the ladder)."""
