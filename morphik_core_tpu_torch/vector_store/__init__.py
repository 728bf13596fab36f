"""The multivector store of the port: one in-memory index per namespace."""
