"""ColQwen2.5 in PyTorch (vision tower, mrope text decoder, projection)."""
