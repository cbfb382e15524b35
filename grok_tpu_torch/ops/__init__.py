"""Device ops of the PyTorch port: MCT, DWT and the HT cleanup decoder."""
