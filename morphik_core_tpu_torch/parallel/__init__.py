"""The device mesh, its collectives, and the blocked ANN scans (single device and mesh)."""
