"""Models — the dense decoder LM (llama3-8b)."""
