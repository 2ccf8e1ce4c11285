"""Model layers, attention, KV paging/quantization and the decoder stack."""
