"""Rerankers of the text retrieval path."""
