"""Mini-batch inference driver."""
