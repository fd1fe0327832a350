"""The plain fp32 reference that decides `correct` (imports nothing of the program)."""
