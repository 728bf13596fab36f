"""The port's parsers: text splitting, HTML/XML/Office/PDF text (stdlib only)."""
