"""Image I/O for the PyTorch port (decode + reference grayscale)."""
