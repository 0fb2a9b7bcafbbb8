"""Training of the port: optimizer, state and the train step."""
