"""Function specs, PWL tables and table quantization (torch)."""
