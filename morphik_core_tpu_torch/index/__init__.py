"""In-memory multivector index and device candidate cache of the port."""
