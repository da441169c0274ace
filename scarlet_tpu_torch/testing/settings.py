"""Canonical regression settings (scarlet_tpu/testing/settings.py; ref:
scarlet/testing/settings.py:1-5)."""
max_iter = 100
e_rel = 1e-4
filters = "grizy"
