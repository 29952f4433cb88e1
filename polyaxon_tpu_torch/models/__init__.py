"""Models of the port: GPT-2 (``gpt2``), its decode cache
(``kv_cache``), greedy generation (``generate``) and the registry."""
