"""CPU tests of the benchmark and its card-only control test."""
