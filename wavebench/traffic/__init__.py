"""The benchmark's operations, one file each, named by a cell's ``op``."""
