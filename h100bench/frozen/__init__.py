"""Arithmetic the benchmark keeps fixed while the program changes: each
module names the commit of ``uc2_torch`` (or ``chip_smoke.py``) it was
copied from."""
