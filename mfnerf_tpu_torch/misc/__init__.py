"""Scripts of the PyTorch port (mirrors the repository's misc/)."""
