"""Models of the port: primitive layers, the plain attention lanes, and
the serving half of the transformer."""
