"""Counterpart of s_volsdf_tpu/data (PyTorch)."""
