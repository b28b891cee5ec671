"""Counterpart of s_volsdf_tpu/models (PyTorch)."""
