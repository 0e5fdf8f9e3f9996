"""Static analysis of the port — port of ``spark_rapids_tpu/analysis``:
:mod:`.plan_lint` verifies every physical plan after planning and after
the overrides pass; :mod:`.concurrency` checks the package's source for
lock cycles, locks held across blocking calls and unguarded writes from
worker threads (``python -m spark_rapids_tpu_torch.analysis.concurrency``).
Nothing is imported here, so the analyzer's command line runs on the
standard library alone.
"""
