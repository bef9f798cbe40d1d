"""Kernels and tensor helpers of the port."""
