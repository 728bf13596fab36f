"""Object storage of the port (local filesystem, the reference's layout)."""
