"""What every cell of the benchmark shares: its files, the generator,
the window, the trace, the peaks and counts."""
