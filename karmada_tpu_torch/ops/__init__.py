"""Solver modules of the port: encoder/decoder (tensors), serial golden
path (serial, webster), the device solve (solver) and its kernels."""
