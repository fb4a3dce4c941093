"""Helper functions for the Sequence class."""
