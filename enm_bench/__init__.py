"""The benchmark of springcraft_tpu_torch on the card (``run.py``)."""
