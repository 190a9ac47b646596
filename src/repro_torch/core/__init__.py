"""Function specs, PWL tables, table quantization and the SGD table fit (torch)."""
