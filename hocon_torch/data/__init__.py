"""Data: the pieces of ``hocon.data`` the main path needs so far."""
