"""The ColPali embedder of the port."""
