"""The hash shuffle exchange: Spark's murmur3 partitioning, partitioners,
the block serializer and the in-memory exchange (port of
``spark_rapids_tpu/shuffle``)."""
