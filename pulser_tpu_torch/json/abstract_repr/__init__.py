"""Abstract representation (wire format) serialization."""
