"""Logical plans, the DataFrame API and planning (port of ``spark_rapids_tpu/plan``)."""
