"""The plain reference the port is compared with (imports nothing of
the program)."""
