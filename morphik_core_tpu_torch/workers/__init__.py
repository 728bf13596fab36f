"""The persistent ingest job queue of the port."""
