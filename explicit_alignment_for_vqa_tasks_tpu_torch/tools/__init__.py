"""Measuring scripts of the port; each runs on a CUDA card."""
