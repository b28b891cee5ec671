"""Counterpart of s_volsdf_tpu/engine (PyTorch)."""
