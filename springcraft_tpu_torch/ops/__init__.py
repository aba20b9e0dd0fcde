"""Array-level building blocks of the PyTorch port (counterpart of
``springcraft_tpu/ops``)."""
