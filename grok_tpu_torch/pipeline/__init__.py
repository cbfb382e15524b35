"""Serving decode of the PyTorch port: host staging and the device program."""
