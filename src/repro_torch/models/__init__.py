"""Models of the port: primitive layers, the plain attention lanes, and
the transformer (its training forward and its serving half)."""
