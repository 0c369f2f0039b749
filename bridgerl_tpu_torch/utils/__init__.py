"""Console logging."""
