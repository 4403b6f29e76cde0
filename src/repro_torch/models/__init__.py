"""Model spec builders for the compiled path."""
