"""Device, dtype and precision helpers of the PyTorch port."""
