"""Host-side helpers: the panels of the --vis dumps."""
