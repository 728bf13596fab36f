"""HTTP service plane of the port: stdlib server, auth, routes, entry point."""
