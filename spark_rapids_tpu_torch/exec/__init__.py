"""Physical operators (port of ``spark_rapids_tpu/exec``)."""
