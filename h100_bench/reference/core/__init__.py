"""Part of the plain reference."""
