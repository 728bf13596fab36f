"""The sqlite metadata database of the port and its metadata filters."""
