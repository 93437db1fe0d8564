"""Geometry, field sampling and BEV rendering in plain torch."""
