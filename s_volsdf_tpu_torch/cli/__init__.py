"""Counterpart of s_volsdf_tpu/cli: the port's command-line entry points."""
