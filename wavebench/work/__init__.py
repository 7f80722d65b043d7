"""The work of an operation counted from its shapes alone."""
