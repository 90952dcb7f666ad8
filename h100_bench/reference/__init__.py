"""Plain float32 forwards, one a model family, that decide whether what
the port served is right.  They import nothing of the port."""
