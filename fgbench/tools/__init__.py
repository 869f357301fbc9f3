"""Tools around the benchmark that its runs do not use."""
