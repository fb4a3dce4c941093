"""JSON serialization for pulser_tpu_torch."""
