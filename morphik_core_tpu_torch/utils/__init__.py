"""Helpers of the service plane: data URIs and a PNG codec without PIL."""
