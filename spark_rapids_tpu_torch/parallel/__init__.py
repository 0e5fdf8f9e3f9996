"""The device mesh and the distributed group-by step (port of
``spark_rapids_tpu/parallel``)."""
