"""Model assembly: layers, attention and the transformer."""
