"""Engine utilities (port of ``spark_rapids_tpu/utils``): lockdep and the
profiler's trace ranges."""
