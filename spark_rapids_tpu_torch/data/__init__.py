"""Columnar data model (port of ``spark_rapids_tpu/data``)."""
