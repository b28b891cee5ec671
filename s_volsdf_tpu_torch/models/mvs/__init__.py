"""Counterpart of s_volsdf_tpu/models/mvs (PyTorch): the CasMVSNet cascade."""
