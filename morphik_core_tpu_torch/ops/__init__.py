"""Kernels and numeric ops of the port (MaxSim, FDE, pooling)."""
