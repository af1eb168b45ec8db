"""Tools that set the benchmark's limits; the benchmark's runs do not use them."""
