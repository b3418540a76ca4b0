"""Input validation."""
