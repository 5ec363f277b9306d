"""The benchmark harness of iamf_tpu_torch (benchport/run.py drives it)."""
