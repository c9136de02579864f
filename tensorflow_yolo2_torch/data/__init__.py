"""Data helpers of the port (numpy only)."""
