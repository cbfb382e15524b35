"""Command-line tools of the PyTorch port (tools/hw_validate.py)."""
