"""File input and output: the parquet scan and the parquet writer."""
