"""Model-family dispatch for the LM side (serving half only)."""
