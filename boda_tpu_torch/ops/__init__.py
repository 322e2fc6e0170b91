"""Kernel templates of the port and their registry."""
