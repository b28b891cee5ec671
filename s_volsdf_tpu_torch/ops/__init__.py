"""Counterpart of s_volsdf_tpu/ops (PyTorch)."""
