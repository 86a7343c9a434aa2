"""Models of the ML stack: DLRM so far."""
