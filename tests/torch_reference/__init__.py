"""Plain float32 PyTorch references of published models, written from
their descriptions and independent of the port: the tests hold the port
to them."""
