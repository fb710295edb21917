"""Models of the port: the Llama family, its paged serving engine, and
the Mixtral sparse-MoE family."""
