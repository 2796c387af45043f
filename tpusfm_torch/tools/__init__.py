"""Tools around the port: the synthetic textured scene renderer."""
