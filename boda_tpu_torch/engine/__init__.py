"""The torch network executor (engine=torch)."""
