"""Contract grammar shared by the port's capacity model."""
