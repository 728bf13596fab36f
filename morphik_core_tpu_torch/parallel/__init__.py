"""Single-device blocked ANN scan + pooled-tier rescore."""
