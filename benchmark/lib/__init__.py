"""The yardstick: traffic generation, operation counts and peaks, the
trace's arithmetic and the comparisons that decide ``correct``."""
