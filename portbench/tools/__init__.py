"""Tools that set the benchmark's limits; the benchmark's own runs do not run them."""
