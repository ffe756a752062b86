"""Model definition and checkpoint I/O."""
