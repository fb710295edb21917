"""Models of the port: the Llama family and its paged serving engine."""
