"""Ingestion, retrieval and telemetry services of the port."""
