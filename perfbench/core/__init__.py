"""The benchmark's yardstick: traffic, tracing, peaks and comparisons."""
