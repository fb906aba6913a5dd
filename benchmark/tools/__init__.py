"""Tools that set the benchmark's limits and rates on the card; the
benchmark's own runs do not call them."""
