"""Model families of the port: Llama-3 and its KV-cache serving path."""
