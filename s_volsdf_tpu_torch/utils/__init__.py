"""Counterpart of s_volsdf_tpu/utils (PyTorch)."""
