"""Models of the port: blocks, the hybrid fusion net and the zoo."""
